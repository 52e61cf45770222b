"""The port's dry-run (``repro_torch.launch.dryrun``): real steps on fake
tensors over a ``"fake"`` process group, in a subprocess of its own
(``init_process_group`` changes its process's default group).

- reduced dense, ssm and moe configs, a train and a decode step each, on
  a fake (2, 4) mesh: FLOPs counted, the train step communicates, and
  each rank's argument bytes (params, moments, batch, cache) are those
  the reference's specs imply for the same shapes on the same mesh, and
  the step's peak beyond them is tracked;
- one full-size combo on the (16, 16) production mesh: Llama-3.2-3B's
  ``decode_32k``, with its collectives by kind and the roofline terms.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as JB
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_abstract_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3_2_3b", "mamba2_2_7b", "mixtral_8x7b")
SHAPES = {"train": ("t16", 16, 8, "train"), "decode": ("d32", 32, 8,
                                                       "decode")}
MESH = (2, 4)

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import base
from repro_torch.launch import dryrun
shapes = json.loads(sys.argv[2])
out = []
for arch in ("llama3_2_3b", "mamba2_2_7b", "mixtral_8x7b"):
    for name, seq, batch, kind in shapes.values():
        # two microbatches of 4 rows, split over the 2 data ranks (the
        # reduced configs' four of 2 would trace twice the passes)
        out.append(dryrun.run_one(arch, base.InputShape(name, seq, batch, kind),
                                  mesh_shape=(2, 4), reduced=True,
                                  config_overrides={"microbatches": 2},
                                  verbose=False))
out.append(dryrun.run_one("llama3_2_3b", "decode_32k", verbose=False))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, os.path.join(ROOT, "src"),
         json.dumps(SHAPES)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def _spec_bytes(shapes, specs, mesh):
    """Each leaf's bytes over the product of its spec's axis sizes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    pspecs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for (_, leaf), spec in zip(flat, pspecs):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for ax in spec:
            for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
                n //= mesh.shape[a]
        total += n
    return total


def _want_args(arch, kind):
    cfg = JB.get_reduced(arch)
    mesh = make_abstract_mesh(MESH, ("data", "model"))
    name, seq, batch, _ = SHAPES[kind]
    shape = JB.InputShape(name, seq, batch, kind)
    p = JST.params_specs(cfg)
    out = {"params": _spec_bytes(p, JSH.param_pspecs(cfg, p, mesh), mesh)}
    if kind == "train":
        out["moments"] = 2 * _spec_bytes(
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.float32),
                         p), JSH.param_pspecs(cfg, p, mesh), mesh)
        b = JST.batch_specs(cfg, shape)
        out["batch"] = _spec_bytes(b, JSH.batch_pspecs(cfg, shape, b, mesh),
                                   mesh)
    else:
        c = {k: v for k, v in JST.cache_specs(cfg, shape).items()
             if k != "idx"}
        out["cache"] = _spec_bytes(c, JSH.cache_pspecs(cfg, c, mesh), mesh)
        t = {"token": JST.token_specs(cfg, shape)}
        out["batch"] = _spec_bytes(t, JSH.batch_pspecs(cfg, shape, t, mesh),
                                   mesh)
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_steps_on_a_fake_mesh(records, arch, kind):
    rec = records[(arch, SHAPES[kind][0], "2x4")]
    assert "error" not in rec, rec.get("traceback")
    assert rec["chips"] == 8 and rec["kind"] == kind
    assert rec["flops_per_chip"] > 0
    assert rec["flops"] == rec["flops_per_chip"] * 8
    assert 0 < rec["useful_flops_ratio"]
    coll = rec["collectives"]
    if kind == "train":
        # FSDP: the weights gathered, the gradients reduce-scattered
        assert coll["calls"]["all-gather"] > 0
        assert coll["calls"]["reduce-scatter"] > 0
    assert coll["bytes"]["total"] > 0
    assert rec["arg_bytes_per_chip"] == _want_args(arch, kind)
    peak = rec["peak_step_bytes_per_chip"]
    assert peak["Total"] > 0 and peak["Activation"] > 0


def test_full_size_combo_on_the_production_mesh(records):
    rec = records[("llama3_2_3b", "decode_32k", "16x16")]
    assert "error" not in rec, rec.get("traceback")
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        JST.params_specs(JB.get_config("llama3_2_3b"))))
    assert rec["chips"] == 256 and rec["n_params"] == n
    assert rec["flops_per_chip"] > 0 and rec["model_flops"] > 0
    assert set(rec["collectives"]["bytes"]) >= {"all-reduce", "all-gather",
                                                "reduce-scatter", "total"}
    for term in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert rec[term] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
