"""The port's cost model (``repro_torch.roofline``) and shape matrix
(``repro_torch.configs.base``) against the JAX package's.

Held: the shape matrix (``INPUT_SHAPES``, ``ARCH_IDS``,
``EXTRA_ARCH_IDS``, ``skip_reason``, ``all_combos``) equals the
reference's; ``model_flops`` and ``active_params`` equal the reference's
for every configuration and shape at several parameter counts; each
kernel's bound at ``chip_smoke.py``'s shapes (``kernel_shapes``) equals
the bound ``PERF.md`` §6 records from the card runs, to 4 decimals; and
``count_flops`` of one reduced dense-LM train step (without and with
remat) and of one reduced ViT ``tpgf_grads_split`` step equals the
reference's ``dot_flops`` of the same step's compiled HLO (compiled in a
subprocess, as ``tests/test_roofline.py`` does) within 1 %. Both count
every matmul of the step, the backward's and remat's recomputed forward
included, at 2 FLOPs a multiply-add; on this tree the counts agree
exactly.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import base as JB  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402

from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as SN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.federated.state import init_train_state  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.roofline import analysis as RF  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ALL_ARCHS = JB.ARCH_IDS + JB.EXTRA_ARCH_IDS
N_PARAMS = (1, 3_000_000_000, 46_700_000_000, 314_000_000_000)


# ------------------------------------------------------------ shape matrix

def test_shape_matrix_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in TB.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JB.INPUT_SHAPES.items()}
    assert TB.ARCH_IDS == JB.ARCH_IDS
    assert TB.EXTRA_ARCH_IDS == JB.EXTRA_ARCH_IDS
    assert TB.all_combos() == JB.all_combos()
    for arch in TB.ARCH_IDS:
        for shape in TB.INPUT_SHAPES:
            assert TB.skip_reason(arch, shape) == JB.skip_reason(arch, shape)


# ------------------------------------------------------------- model FLOPs

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_active_params_match_reference(arch):
    tcfg, jcfg = TB.get_config(arch), JB.get_config(arch)
    shapes = {**JB.INPUT_SHAPES,
              "reduced": JB.InputShape("reduced", 32, 4, "train")}
    for n in N_PARAMS:
        na = RA.active_params(jcfg, n)
        assert RF.active_params(tcfg, n) == na
        for name, js in shapes.items():
            ts = TB.InputShape(js.name, js.seq_len, js.global_batch, js.kind)
            assert RF.model_flops(tcfg, ts, n, na) \
                == RA.model_flops(jcfg, js, n, na), (name, n)


def test_roofline_terms_and_mfu():
    t = RF.roofline_terms(989e12, 3.35e12, torch.bfloat16)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    assert RF.roofline_terms(1e12, 1e9, "float32")["dominant"] == "compute"
    assert RF.roofline_terms(1e9, 1e12, "float32")["dominant"] == "memory"
    assert RF.mfu(67e12, 2.0, torch.float32) == pytest.approx(0.5)
    assert RF.HW.peak("tf32") == 495e12


# ----------------------------------------------------------- kernel bounds

def _shapes():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.kernel_shapes()


# (row of PERF.md §6's kernel table, bound in ms there, bound_by)
BOUNDS = {
    "fuse": (lambda s: RF.fuse_work(math.prod(s["fuse"])),
             "float32", 0.0845, "bytes"),
    "fuse_bf16": (lambda s: RF.fuse_work(math.prod(s["fuse_bf16"]), 2),
                  "float32", 0.3756, "bytes"),
    "tier_sum": (lambda s: RF.tier_sum_work(2, math.prod(s["tier_sum"])),
                 "float32", 0.0592, "bytes"),
    "sumsq": (lambda s: RF.sumsq_work(math.prod(s["sumsq"])),
              "float32", 0.0282, "bytes"),
    "aggregate": (lambda s: RF.aggregate_work(*s["aggregate"]),
                  "float32", 0.3380, "bytes"),
    "flash": (lambda s: RF.flash_work(*s["flash"]),
              "bfloat16", 0.1043, "operations"),
    "flash_mixtral": (lambda s: RF.flash_work(*s["flash_mixtral"]),
                      "bfloat16", 0.8339, "operations"),
    "flash_internvl2": (lambda s: RF.flash_work(*s["flash_internvl2"]),
                        "bfloat16", 0.0695, "operations"),
    "flash_whisper": (lambda s: RF.flash_work(*s["flash_whisper"]),
                      "bfloat16", 0.0066, "bytes"),
    "ssd_scan": (lambda s: RF.ssd_work(*s["ssd_scan"]),
                 "float32", 0.3416, "operations"),
}


@pytest.fixture(scope="module")
def kernel_shapes():
    return _shapes()


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_bound_at_the_smoke_shapes_is_perfs(kernel_shapes, name):
    work, dtype, want_ms, want_by = BOUNDS[name]
    ms, by = RF.bound(*work(kernel_shapes), RF.HW.peak(dtype))
    assert round(ms, 4) == want_ms
    assert by == want_by


def test_attended_pairs_counts_the_masks():
    assert RF.attended_pairs(4, 4, True, 0) == 10
    assert RF.attended_pairs(4, 4, False, 0) == 16
    assert RF.attended_pairs(5, 5, True, 2) == 9
    assert RF.attended_pairs(3, 6, False, 2) == 17   # no upper bound


# ---------------------------------------------------------- counted FLOPs

LM_BATCH, LM_SEQ = 4, 32
VIT_BATCH, VIT_DEPTH = 8, 2
SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)

_REFERENCE = textwrap.dedent(f"""
    import json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from repro import optim as O
    from repro.configs import base
    from repro.core import supernet as SN, tpgf as T
    from repro.federated.state import init_train_state
    from repro.launch.steps import make_train_step
    from repro.models import model as M
    from repro.roofline import analysis as RA
    out = {{}}
    for remat in (False, True):
        cfg = base.get_reduced("llama3_2_3b").replace(remat=remat)
        params = M.init_params(cfg, jax.random.PRNGKey(0))
        step, opt = make_train_step(cfg, O.sgd(0.1))
        batch = {{k: jnp.zeros(({LM_BATCH}, {LM_SEQ}), jnp.int32)
                  for k in ("tokens", "labels")}}
        hlo = jax.jit(step).lower(params, opt.init(params),
                                  batch).compile().as_text()
        out[f"lm/remat={{remat}}"] = RA.dot_flops(hlo)
    cfg = base.get_reduced("vit16_cifar").replace(**{SMALL!r})
    ts = init_train_state(cfg, 3, seed=0)
    c, s, _ = SN.split_params(cfg, ts.params, {VIT_DEPTH}, 1.0)
    head = jax.tree.map(lambda x: x[0], ts.local_heads)
    batch = {{"images": jnp.zeros(({VIT_BATCH}, 16, 16, 3)),
              "label": jnp.zeros(({VIT_BATCH},), jnp.int32)}}
    fn = jax.jit(lambda c, s, h, b: T.tpgf_grads_split(
        cfg, cfg, c, s, h, b, {VIT_DEPTH}, server_available=True))
    out["vit/tpgf_grads_split"] = RA.dot_flops(
        fn.lower(c, s, head, batch).compile().as_text())
    print("FLOPS", json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("FLOPS ")]
    assert line, r.stderr[-3000:]
    return json.loads(line[-1][len("FLOPS "):])


def _port_flops(case):
    if case.startswith("lm/"):
        cfg = TB.get_reduced("llama3_2_3b").replace(
            remat=case.endswith("True"))
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step, opt = make_train_step(cfg, TO.sgd(0.1))
        batch = {k: torch.zeros(LM_BATCH, LM_SEQ, dtype=torch.int64)
                 for k in ("tokens", "labels")}
        return RF.count_flops(step, params, opt.init(params), batch)[0]
    cfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    ts = init_train_state(cfg, 3, seed=0, device="cpu")
    c, s, _ = SN.split_params(cfg, ts.params, VIT_DEPTH, 1.0)
    batch = {"images": torch.zeros(VIT_BATCH, 16, 16, 3),
             "label": torch.zeros(VIT_BATCH, dtype=torch.int64)}
    return RF.count_flops(TT.tpgf_grads_split, cfg, cfg, c, s,
                          ts.head_for(0), batch, VIT_DEPTH,
                          server_available=True)[0]


@pytest.mark.parametrize("case", ["lm/remat=False", "lm/remat=True",
                                  "vit/tpgf_grads_split"])
def test_count_flops_matches_the_reference_hlo(reference_flops, case):
    want = reference_flops[case]
    assert want > 0
    assert _port_flops(case) == pytest.approx(want, rel=1e-2)
