"""Shared harness of the port's whole-slice parity tests: the same run
through a live JAX ``Engine`` and the port's, at the
``tests/test_fused_parity.py`` setting (reduced ViT, 6 clients, seed 0,
lr 0.3, local_steps 2, batch 8, availability 0.8), the port started from
the reference's weights through ``repro_torch.bridge``.

Limits (the reference's own): round loss 1e-5 absolute; the cost-model
record fields exactly; final params and server optimizer state 1e-4;
fleet depths and widths, availability draws and batch indices exactly.

``between(engine, r)``, when given, runs on both engines before round
``r`` (r >= 1): the same edit on both sides, e.g. a re-tuned budget.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as JB
from repro.federated import Engine as JEngine

from repro_torch import bridge
from repro_torch.configs import base as TB
from repro_torch.federated import Engine as TEngine
from repro_torch.tree import tree_flatten_with_path

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
ARGS = dict(seed=0, lr=0.3, local_steps=2, batch_size=8, availability=0.8)
N_CLIENTS = 6
ROUNDS = 2
LADDER = (0.25, 0.5, 0.75, 1.0)


def record_streams(engine):
    """Wrap an engine's availability and batch-index draws to log them."""
    log = {"avail": [], "idx": []}
    draw, sample = engine.avail_model.draw, engine._sample_indices

    def logged_draw(n):
        out = draw(n)
        log["avail"].append(out.copy())
        return out

    def logged_sample(*a, **k):
        out = sample(*a, **k)
        log["idx"].append(out.copy())
        return out

    engine.avail_model.draw = logged_draw
    engine._sample_indices = logged_sample
    return log


def flat_jax(tree):
    return {tuple(k.key for k in p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree):
    return {p: x.detach().cpu().numpy()
            for p, x in tree_flatten_with_path(tree)}


def _settings(strategy, cfg_kw, kw):
    kw = dict(ARGS, **kw)
    return strategy, dict(SMALL, **cfg_kw), kw


def _rounds(eng, between):
    recs = []
    for r in range(ROUNDS):
        if r and between is not None:
            between(eng, r)
        recs.append(eng.run_round())
    return recs


def run_reference(strategy="ssfl", cfg_kw=None, between=None, **kw):
    """Two rounds of the JAX engine; its weights before them, its records,
    streams, final params and server optimizer state after them."""
    strategy, cfg_kw, kw = _settings(strategy, cfg_kw or {}, kw)
    cfg = JB.get_reduced("vit16_cifar").replace(**cfg_kw)
    eng = JEngine(cfg, N_CLIENTS, strategy, **kw)
    weights = (jax.tree.map(np.asarray, eng.state.params),
               jax.tree.map(np.asarray, eng.state.local_heads))
    log = record_streams(eng)
    recs = _rounds(eng, between)
    return {"weights": weights, "recs": recs, "log": log,
            "params": flat_jax(eng.state.params),
            "server": (flat_jax(eng.state.opt_state["server"])
                       if "server" in eng.state.opt_state else None),
            "opt_state": flat_jax(eng.state.opt_state),
            "depths": eng.state.fleet.depths.copy(),
            "widths": np.asarray(eng.state.fleet.widths).copy(),
            "acc_global": eng.evaluate(head="global"), "engine": eng}


def run_port(reference, use_pallas, strategy="ssfl", cfg_kw=None,
             between=None, **kw):
    """The same two rounds through the port from the reference's
    weights."""
    strategy, cfg_kw, kw = _settings(strategy, cfg_kw or {}, kw)
    cfg = TB.get_reduced("vit16_cifar").replace(use_pallas=use_pallas,
                                                **cfg_kw)
    eng = TEngine(cfg, N_CLIENTS, strategy, device="cpu", **kw)
    bridge.install_weights(eng, *reference["weights"])
    log = record_streams(eng)
    recs = _rounds(eng, between)
    return {"engine": eng, "recs": recs, "log": log,
            "params": flat_torch(eng.state.params),
            "server": (flat_torch(eng.state.opt_state["server"])
                       if "server" in eng.state.opt_state else None),
            "opt_state": flat_torch(eng.state.opt_state)}


def assert_records_match(reference, port):
    assert len(port["recs"]) == len(reference["recs"]) == ROUNDS
    for want, rec in zip(reference["recs"], port["recs"]):
        assert rec.keys() == want.keys()
        assert rec["loss"] == pytest.approx(want["loss"], abs=1e-5)
        for k in want:
            if k != "loss":
                assert rec[k] == want[k], k


def assert_close(got, want, what):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (what, k)
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} {k}")


def assert_params_and_server_match(reference, port):
    assert_close(port["params"], reference["params"], "params")
    assert (port["server"] is None) == (reference["server"] is None)
    if reference["server"] is not None:
        assert_close(port["server"], reference["server"], "server")


def assert_streams_match(reference, port):
    fleet = port["engine"].state.fleet
    np.testing.assert_array_equal(fleet.depths, reference["depths"])
    np.testing.assert_array_equal(fleet.widths, reference["widths"])
    for key in ("avail", "idx"):
        assert len(port["log"][key]) == len(reference["log"][key])
        for a, b in zip(port["log"][key], reference["log"][key]):
            np.testing.assert_array_equal(a, b)
