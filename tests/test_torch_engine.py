"""The slice as a whole: the port's ``ssfl`` Engine against a live JAX
Engine, both started from the same weights through the bridge, at the
``tests/test_fused_parity.py`` setting (reduced ViT, 6 clients, seed 0,
lr 0.3, local_steps 2, batch 8, availability 0.8).

Held: round losses within 1e-5 absolute; the cost-model records
(``comm_mb``, ``time_s`` and the rest) exactly; final params within 1e-4;
fleet depths, availability draws and batch indices exactly; evaluate()
accuracies (global head and local ensemble) exactly. The port runs with
``use_pallas`` off and on (on the CPU the kernels' plain versions); the
reference runs its plain path, which is what its ``ssfl`` executes.
``test_engine_settings_match_reference`` holds the same at the settings
no other port test reaches: ``sample_frac=0.5``, the Fig. 6
``tpgf_variant`` ablations and ``sgd_momentum``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402
from _torch_parity import (ARGS, N_CLIENTS, ROUNDS, SMALL,  # noqa: E402
                           record_streams as _record_streams)

import jax  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated import engine as TE  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402


@pytest.fixture(scope="module")
def reference():
    cfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    eng = JEngine(cfg, N_CLIENTS, "ssfl", **ARGS)
    weights = (jax.tree.map(np.asarray, eng.state.params),
               jax.tree.map(np.asarray, eng.state.local_heads))
    log = _record_streams(eng)
    recs = [eng.run_round() for _ in range(ROUNDS)]
    params = {tuple(k.key for k in p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(eng.state.params)[0]}
    return {"weights": weights, "recs": recs, "params": params, "log": log,
            "depths": eng.state.fleet.depths.copy(),
            "acc_global": eng.evaluate(head="global"),
            "acc_local": eng.evaluate(head="local")}


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, reference):
    """The port's two rounds from the reference's weights, once per
    ``use_pallas`` value."""
    cfg = TB.get_reduced("vit16_cifar").replace(use_pallas=request.param,
                                                **SMALL)
    eng = TEngine(cfg, N_CLIENTS, "ssfl", device="cpu", **ARGS)
    bridge.install_weights(eng, *reference["weights"])
    log = _record_streams(eng)
    recs = [eng.run_round() for _ in range(ROUNDS)]
    return {"engine": eng, "recs": recs, "log": log,
            "params": {p: x.numpy() for p, x in
                       tree_flatten_with_path(eng.state.params)}}


def test_two_round_records_match(reference, port):
    got = port["recs"]
    for want, rec in zip(reference["recs"], got):
        assert rec.keys() == want.keys()
        assert rec["loss"] == pytest.approx(want["loss"], abs=1e-5)
        for k in want:
            if k != "loss":
                assert rec[k] == want[k], k


def test_final_params_match(reference, port):
    got = port["params"]
    assert got.keys() == reference["params"].keys()
    for k, want in reference["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-4,
                                   err_msg=str(k))


def test_fleet_availability_and_batches_match(reference, port):
    run = port
    np.testing.assert_array_equal(run["engine"].state.fleet.depths,
                                  reference["depths"])
    for key in ("avail", "idx"):
        assert len(run["log"][key]) == len(reference["log"][key])
        for a, b in zip(run["log"][key], reference["log"][key]):
            np.testing.assert_array_equal(a, b)


def test_evaluate_matches(reference, port):
    eng = port["engine"]
    assert eng.evaluate(head="global") == reference["acc_global"]
    assert eng.evaluate(head="local") == reference["acc_local"]
    assert eng.evaluate() == reference["acc_global"]


def test_train_runs_rounds_and_evaluates():
    cfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    eng = (TEngine.builder(cfg).clients(4, availability=0.9)
           .optimizer("sgd", lr=0.3).rounds(local_steps=1, batch_size=8)
           .execution(device="cpu").build())
    rec = eng.train(2, eval_every=1)
    assert rec["round"] == 2 and 0.0 <= rec["accuracy"] <= 1.0
    assert np.isfinite(rec["loss"])


def test_availability_zero_freezes_server_and_evaluates_locally():
    cfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    eng = TEngine(cfg, 5, "ssfl", device="cpu", optimizer="adamw", lr=0.05,
                  local_steps=2, batch_size=8, availability=0.0)
    head = eng.state.params["head"].clone()
    head_bias = eng.state.params["head_bias"].clone()
    for _ in range(2):
        rec = eng.run_round()
        assert np.isfinite(rec["loss"])
    # the server branch never stepped: bit-exact head, moments untouched
    assert torch.equal(eng.state.params["head"], head)
    assert torch.equal(eng.state.params["head_bias"], head_bias)
    srv = eng.state.opt_state["server"]
    assert int(srv["t"]) == 0
    assert all(not x.any() for _, x in tree_flatten_with_path(srv["m"]))
    # nobody reached the server: evaluate() serves the local ensemble
    assert eng._server_updates == 0
    assert eng.evaluate() == eng.evaluate(head="local")


def test_engine_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TEngine(cfg, 3, "ssfl")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TE.resolve_device(None)


# ``sanitize=True`` left this list when the sanitizer was ported
# (tests/test_torch_sanitize.py holds it)
@pytest.mark.parametrize("kw,match", [
    ({"mesh": object()}, "Fleet sharding"),
])
def test_outside_the_slice_raises(kw, match):
    cfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    with pytest.raises(NotImplementedError, match=match):
        TEngine(cfg, 3, "ssfl", device="cpu", **kw)


# Engine settings no other port test holds: each case runs the reference
# and the port (kernels on) for two rounds and holds all of the above
SETTINGS = {
    "sample_frac=0.5": dict(kw=dict(sample_frac=0.5)),
    "tpgf_variant=no_loss": dict(cfg_kw=dict(tpgf_variant="no_loss")),
    "tpgf_variant=no_depth": dict(cfg_kw=dict(tpgf_variant="no_depth")),
    "tpgf_variant=equal": dict(cfg_kw=dict(tpgf_variant="equal")),
    "sgd_momentum": dict(kw=dict(optimizer="sgd_momentum")),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_engine_settings_match_reference(setting):
    cfg_kw = SETTINGS[setting].get("cfg_kw", {})
    kw = SETTINGS[setting].get("kw", {})
    ref = P.run_reference("ssfl", cfg_kw=cfg_kw, **kw)
    run = P.run_port(ref, True, "ssfl", cfg_kw=cfg_kw, **kw)
    P.assert_records_match(ref, run)
    P.assert_params_and_server_match(ref, run)
    P.assert_streams_match(ref, run)
    assert run["engine"].evaluate(head="global") == ref["acc_global"]
