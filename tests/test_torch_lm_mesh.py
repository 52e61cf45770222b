"""The port's LM families sharded over a ``("data", "model")`` mesh
(``models/sharded.py``) against the live JAX reference.

One child (``tests/_torch_lm_mesh_child.py``: torch, numpy and the port
only) spawns four gloo ranks on a (2, 2) mesh and runs, from the
reference's weights (nudged, as ``tests/_torch_lm.py`` makes them):

- the prefill of reduced dense, moe, ssm, hybrid, vlm and audio configs:
  logits and every cache entry (2e-5);
- decode step by step for dense, moe and ssm (2e-5);
- two train steps for dense and ssm (the ssm with ``use_pallas``, its
  Eq. 4 through ``fuse`` under ``local_map``): metrics 1e-5, params 1e-4;
- the sharded ``init_params`` against the meshless one of the same seed
  (exactly), and a mesh of CUDA tensors over the gloo group refused;

then, in its own process, a (1, 1) mesh against the meshless run, bit
for bit. Batches of 4 rows split over the two data ranks (the ssm's two
microbatches of 2 too); every reduced config shards whole heads over
the two ``"model"`` ranks.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as JB
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import decode as JD

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_lm import (OPTS, flat_jax, lm_batches, nudged_weights,
                       to_jax_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_lm_mesh_child.py")
ARCHS = {"dense": "llama3_2_3b", "moe": "mixtral_8x7b", "ssm": "mamba2_2_7b",
         "hybrid": "hymba_1_5b", "vlm": "internvl2_2b",
         "audio": "whisper_small"}
DECODE = ("dense", "moe", "ssm")
TRAIN = {"dense": dict(cfg={"microbatches": 1}, opt="adamw"),
         "ssm": dict(cfg={"microbatches": 2, "use_pallas": True},
                     opt="sgd"),
         "moe": dict(cfg={"microbatches": 1}, opt="sgd")}
MESH11 = ("dense", "moe", "ssm")
B, S, PROMPT, NEXT, BUDGET, STEPS = 4, 12, 8, 4, 4, 2
TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_TOL, PARAM_TOL = 1e-5, 1e-4
GROUP_TIMEOUT = 120


def _cases():
    four = [f"prefill_{a}" for a in ARCHS.values()]
    four += [f"decode_{ARCHS[f]}" for f in DECODE]
    four += [f"train_{ARCHS[f]}" for f in ("dense", "ssm")]
    return four + ["init", "refusal"], [f"mesh11_{ARCHS[f]}"
                                        for f in MESH11]


def _inputs(arch, family):
    """The numpy inputs of every case of ``arch``."""
    cfg = JB.get_reduced(arch)
    out = {k: v for k, v in lm_batches(cfg, B, S, 1, seed=3)[0].items()
           if k != "labels"}
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, (B, PROMPT + NEXT)).astype(np.int32)
    out["prompt"], out["next"] = toks[:, :PROMPT], toks[:, PROMPT:]
    if family in TRAIN:
        bs = lm_batches(cfg, B, S, STEPS, seed=5)
        out["train_tokens"] = np.stack([b["tokens"] for b in bs])
        out["train_labels"] = np.stack([b["labels"] for b in bs])
    return out


def _jax_serve(jcfg, jp, inputs, decode):
    if decode:
        batch = {"tokens": jnp.asarray(inputs["prompt"])}
    else:
        batch = {k: jnp.asarray(inputs[k]) for k in ("tokens", "patches",
                                                      "frames")
                 if k in inputs}
    logits, cache = JD.prefill(jcfg, jp, batch, decode_budget=BUDGET)
    out = {"logits": np.asarray(logits, np.float32)}
    out.update({f"cache/{k}": np.asarray(v, np.float32)
                for k, v in cache.items() if k != "idx"})
    if decode:
        step = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
        for t in range(NEXT):
            lg, cache = step(jp, cache, jnp.asarray(inputs["next"][:, t:t + 1]))
            out[f"step{t}"] = np.asarray(lg, np.float32)
        out.update({f"final/{k}": np.asarray(v, np.float32)
                    for k, v in cache.items() if k != "idx"})
    return out


def _jax_train(arch, weights, inputs, spec):
    jcfg = JB.get_reduced(arch).replace(**spec["cfg"])
    jopt = OPTS[spec["opt"]][0]()
    step = jax.jit(j_make_train_step(jcfg, jopt)[0])
    jp = jax.tree.map(jnp.asarray, weights)
    js = jopt.init(jp)
    out = {}
    for i in range(STEPS):
        jp, js, m = step(jp, js, to_jax_batch(
            {"tokens": inputs["train_tokens"][i],
             "labels": inputs["train_labels"][i]}))
        out.update({f"metric{i}/{k}": float(v) for k, v in m.items()})
    out.update({"param/" + "/".join(p): x for p, x in flat_jax(jp).items()})
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(the child's results by case, the reference's by case)."""
    workdir = str(tmp_path_factory.mktemp("lm_mesh"))
    spec, want = {}, {}
    for family, arch in ARCHS.items():
        weights = nudged_weights(arch)
        inputs = _inputs(arch, family)
        np.savez(os.path.join(workdir, f"{arch}.npz"),
                 **{"w/" + "/".join(p): x
                    for p, x in flat_jax(weights).items()},
                 **{f"b/{k}": v for k, v in inputs.items()})
        jcfg = JB.get_reduced(arch)
        jp = jax.tree.map(jnp.asarray, weights)
        spec[f"prefill_{arch}"] = {"arch": arch, "budget": BUDGET}
        want[f"prefill_{arch}"] = _jax_serve(jcfg, jp, inputs, False)
        if family in DECODE:
            spec[f"decode_{arch}"] = {"arch": arch, "budget": BUDGET}
            want[f"decode_{arch}"] = _jax_serve(jcfg, jp, inputs, True)
        if family in TRAIN:
            spec[f"train_{arch}"] = dict(TRAIN[family], arch=arch,
                                         steps=STEPS)
            if family != "moe":
                want[f"train_{arch}"] = _jax_train(arch, weights, inputs,
                                                   TRAIN[family])
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    four, one = _cases()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, CHILD, workdir, "4:" + ",".join(four),
         "1:" + ",".join(one)], capture_output=True, text=True, env=env,
        timeout=3 * GROUP_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = {}
    for ranks, cases in ((4, four), (1, one)):
        for case in cases:
            data = np.load(os.path.join(workdir, f"ranks{ranks}",
                                        f"{case}.npz"))
            got[case] = {k: data[k] for k in data.files}
    return got, want


def _assert_serve(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_matches_reference(mesh_runs, family):
    got, want = mesh_runs
    case = f"prefill_{ARCHS[family]}"
    _assert_serve(got[case], want[case])


@pytest.mark.parametrize("family", DECODE)
def test_decode_step_by_step_matches_reference(mesh_runs, family):
    got, want = mesh_runs
    case = f"decode_{ARCHS[family]}"
    _assert_serve(got[case], want[case])


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_train_steps_match_reference(mesh_runs, family):
    got, want = mesh_runs
    case = f"train_{ARCHS[family]}"
    g, w = got[case], want[case]
    assert sorted(g) == sorted(w)
    for k in w:
        if k.startswith("metric"):
            assert abs(float(g[k]) - w[k]) <= METRIC_TOL, (k, g[k], w[k])
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_TOL,
                                       err_msg=k)


def test_sharded_init_is_the_meshless_init(mesh_runs):
    got, _ = mesh_runs
    assert {k: float(v) for k, v in got["init"].items()} == {
        a: 0.0 for a in ("llama3_2_3b", "mixtral_8x7b", "mamba2_2_7b",
                         "whisper_small")}


def test_gloo_mesh_of_cuda_tensors_raises(mesh_runs):
    got, _ = mesh_runs
    err = str(got["refusal"]["error"])
    assert "gloo runs only all_reduce and broadcast on CUDA tensors" in err


@pytest.mark.parametrize("family", MESH11)
def test_one_rank_mesh_is_the_meshless_run(mesh_runs, family):
    """Prefill, decode and two train steps on a (1, 1) mesh: bit for bit
    the meshless run (every region is the meshless code on whole
    tensors, the residuals inside, so even the gradients sum in the
    same order)."""
    got, _ = mesh_runs
    res = got[f"mesh11_{ARCHS[family]}"]
    assert float(res["serve"]) == 0.0 and float(res["train"]) == 0.0
