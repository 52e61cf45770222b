"""Shared harness of the moe, vlm and audio parity tests: the reference's
weights nudged and carried across, the same batches on both sides, the
live JAX train step beside the port's, and the comparisons.

Each test module imports what it needs; the tolerances are the LM
slice's (``tests/test_torch_lm_train.py``): metrics 1e-5, params 1e-4,
logits and caches 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import optim as JO
from repro.configs import base as JB
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM

from repro_torch import bridge
from repro_torch import optim as TO
from repro_torch.configs import base as TB
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import model as TM
from repro_torch.tree import tree_flatten_with_path

METRIC_TOL = 1e-5
PARAM_TOL = 1e-4
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
OPTS = {"adamw": (lambda: JO.adamw(1e-3, weight_decay=0.1),
                  lambda: TO.adamw(1e-3, weight_decay=0.1)),
        "sgd": (lambda: JO.sgd(0.1), lambda: TO.sgd(0.1))}


def nudged_weights(arch, seed=0, scale=0.02, **cfg_kw):
    """The reference's ``init_params`` for the reduced ``arch``, every
    leaf nudged by N(0, scale²) (so the zero-initialised norms shape the
    output too); numpy fp32."""
    cfg = JB.get_reduced(arch).replace(**cfg_kw)
    p = JM.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 7)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.standard_normal(
        x.shape)).astype(np.float32), p)


def np_of(x):
    """A numpy fp32 copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().copy()
    return np.asarray(x, np.float32)


def flat_jax(tree):
    return {tuple(getattr(k, "key", k) for k in p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_params_close(jtree, ttree, tol=PARAM_TOL):
    want = flat_jax(jtree)
    got = {p: np_of(x) for p, x in tree_flatten_with_path(ttree)}
    assert sorted(want) == sorted(got)
    for path, x in want.items():
        np.testing.assert_allclose(got[path], x, rtol=0, atol=tol,
                                   err_msg=str(path))


def lm_batches(cfg, batch, seq, n, seed=1):
    """``n`` numpy batches of ``synthetic_lm_batches``; a vlm batch gets
    seeded N(0, 1) ``patches`` [batch, n_patches, d_model] and an audio
    batch seeded N(0, 1) ``frames`` [batch, enc_frames, d_model] (fp32)."""
    out = list(synthetic_lm_batches(cfg.vocab, seq, batch, n, seed=seed))
    extra = TM.side_input_shapes(cfg, batch)
    rng = np.random.default_rng(seed + 50)
    for b in out:
        for k, shape in extra.items():
            b[k] = rng.standard_normal(shape).astype(np.float32)
    return out


def to_jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def run_train_both(weights, arch, mb, opt, batches, **cfg_kw):
    """``len(batches)`` steps of the jitted JAX ``make_train_step`` and
    the port's from the same weights; returns (their metric records,
    the final JAX params, the final port params)."""
    jcfg = JB.get_reduced(arch).replace(microbatches=mb, **cfg_kw)
    tcfg = TB.get_reduced(arch).replace(microbatches=mb, **cfg_kw)
    jopt, topt = (f() for f in OPTS[opt])
    jstep = jax.jit(j_make_train_step(jcfg, jopt)[0])
    tstep, _ = TSTEPS.make_train_step(tcfg, topt)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = bridge.to_model_params(tcfg, weights, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jrec, trec = [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, to_jax_batch(b))
        tp, ts, tm = tstep(tp, ts, to_torch_batch(b))
        jrec.append({k: float(v) for k, v in jm.items()})
        trec.append({k: float(v) for k, v in tm.items()})
    return jrec, trec, jp, tp


def assert_metrics_close(jrec, trec):
    assert [sorted(r) for r in trec] == [
        ["aux", "loss_client", "loss_server", "w_client"]] * len(jrec)
    for j, t in zip(jrec, trec):
        for k in j:
            assert abs(j[k] - t[k]) <= METRIC_TOL, (k, j[k], t[k])
