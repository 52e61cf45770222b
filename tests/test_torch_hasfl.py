"""The port's ``hasfl`` strategy (per-round depth/batch/width co-tuning)
against a live JAX ``Engine``, and its accounting.

Two rounds at the ``tests/_torch_parity.py`` setting (reduced ViT, 6
clients, seed 0, the reference's weights), each with ``use_pallas`` off
and on:

  * ``depth-batch`` — the depth-and-batch solve (one width);
  * ``retuned-momentum`` — the same with heavy-ball momentum, the budget
    cut from 1.0 to 0.5 before round 2 on both sides, so the tuned depths
    change between rounds (two clients move from depth 3 and 2 to depth
    1) and the server moments are sliced and merged at the new depths;
  * ``ladder-fused`` — width tiers (0.25, 0.5, 0.75, 1.0), budget 1.1 then
    0.95, momentum, ``cross_tier="fused"``: the depth-1 cohort holds two
    width tiers (``fuse_tiers`` over batch groups chained per tier);
  * ``ladder-chained`` — the same fleet with ``cross_tier="chained"``
    (SGD).

Held: round losses 1e-5, the cost-model records exactly (they read each
cohort's tuned tokens and every client's tuned batch), final params and
server moments 1e-4, the tuned depths, batches and widths, the
availability and batch-index streams exactly. The moment cases take
momentum, not AdamW: the clients' AdamW is fresh each round, so its first
step is sign(g), and a gradient element near zero turns float noise into
a step of lr. With AdamW (lr 0.01) the port reads 1.7e-4 (retuned) and
5.9e-4 (ladder-fused) on 1–4 elements at round 2, where a one-ulp nudge
of one weight moves the reference 2.6e-4 against itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402

from repro.federated.strategies.hasfl import HASFL as JHASFL  # noqa: E402

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as SN  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated.strategies import HASFL  # noqa: E402


def _budget(factor):
    def set_budget(engine, r):
        engine.strategy.time_budget_factor = factor
    return set_budget


CASES = {
    "depth-batch": dict(strategy={}, kw={}),
    "retuned-momentum": dict(strategy={}, kw=dict(optimizer="sgd_momentum"),
                             between=_budget(0.5)),
    "ladder-fused": dict(strategy=dict(width_tiers=P.LADDER,
                                       time_budget_factor=1.1),
                         kw=dict(optimizer="sgd_momentum",
                                 cross_tier="fused"),
                         between=_budget(0.95)),
    "ladder-chained": dict(strategy=dict(width_tiers=P.LADDER,
                                         time_budget_factor=1.1),
                           kw=dict(cross_tier="chained"),
                           between=_budget(0.95)),
}


def _tuned(eng):
    fl = eng.state.fleet
    return (fl.depths.copy(), np.asarray(eng.strategy._bs).copy(),
            np.asarray(fl.widths, np.float64).copy())


def _logged(between):
    """Record the tuned fleet of every round (after its retune)."""
    def hook(engine, r):
        engine._tuned_log = getattr(engine, "_tuned_log", [])
        engine._tuned_log.append(_tuned(engine))
        if between is not None:
            between(engine, r)
    return hook


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def reference(case):
    c = CASES[case]
    ref = P.run_reference(JHASFL(**c["strategy"]),
                          between=_logged(c.get("between")), **c["kw"])
    eng = ref["engine"]
    ref["tuned"] = eng._tuned_log + [_tuned(eng)]
    return ref


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, case, reference):
    c = CASES[case]
    run = P.run_port(reference, request.param, HASFL(**c["strategy"]),
                     between=_logged(c.get("between")), **c["kw"])
    eng = run["engine"]
    run["tuned"] = eng._tuned_log + [_tuned(eng)]
    return run


def test_records_match(reference, port):
    P.assert_records_match(reference, port)


def test_params_and_server_moments_match(reference, port):
    P.assert_params_and_server_match(reference, port)


def test_tuned_fleets_and_streams_match(case, reference, port):
    P.assert_streams_match(reference, port)
    assert len(port["tuned"]) == len(reference["tuned"]) == P.ROUNDS
    for got, want in zip(port["tuned"], reference["tuned"]):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    (d1, b1, w1), (d2, b2, w2) = port["tuned"]
    if case != "depth-batch":
        assert (d1 != d2).any()           # re-tuning moved depths
    if case.startswith("ladder"):
        # a depth cohort holds two width tiers (and two batch groups)
        assert any(len(set(w1[d1 == d])) > 1 for d in set(d1.tolist()))
        assert len(set(b1[d1 == 1].tolist())) > 1
    assert port["engine"].evaluate(head="global") == reference["acc_global"]


# --------------------------------------------------------------- the port

def _cfg():
    return TB.get_reduced("vit16_cifar").replace(**P.SMALL)


def _engine(strategy, n_clients=6, **kw):
    return TEngine(_cfg(), n_clients, strategy, device="cpu",
                   **dict(P.ARGS, **kw))


def test_per_id_pricing_matches_hand_computed():
    """Tuned batches pinned to (4, 8, 16): with ``ids`` each client's
    smashed traffic is priced at its OWN batch, without them at the fleet
    mean of the depth."""
    eng = _engine("hasfl", n_clients=3, local_steps=2)
    strat = eng.strategy
    strat._bs = np.array([4, 8, 16])
    eng.state.fleet.depths[:] = 2
    d = 2
    pbytes = SN.client_param_bytes(eng.cfg, eng.state.params, d)
    per_tok = eng.tokens_per_sample() * eng.cfg.d_model * 4
    ids = np.array([0, 2])
    nbytes, nmsg = strat.comm_cost(eng, d, True, ids=ids)
    np.testing.assert_array_equal(
        nbytes, [2 * pbytes + eng.local_steps * 2 * b * per_tok
                 for b in (4, 16)])
    np.testing.assert_array_equal(nmsg, [2 + 2 * eng.local_steps] * 2)
    nbytes, _ = strat.comm_cost(eng, d, False, ids=ids)
    np.testing.assert_array_equal(nbytes, [2 * pbytes] * 2)
    scalar, msgs = strat.comm_cost(eng, d, True)
    assert scalar == 2 * pbytes + eng.local_steps * 2 * int(
        (28 / 3) * per_tok)
    assert msgs == 2 + 2 * eng.local_steps


def test_width_tiers_price_each_clients_slice():
    eng = _engine(HASFL(width_tiers=P.LADDER, time_budget_factor=1.1))
    eng.run_round()
    fl = eng.state.fleet
    ids = np.where(fl.depths == 1)[0]
    nbytes, _ = eng.strategy.comm_cost(eng, 1, False, ids=ids)
    want = [2 * SN.client_param_bytes(eng.cfg, eng.state.params, 1,
                                      float(fl.widths[i])) for i in ids]
    np.testing.assert_array_equal(nbytes, want)
    assert len(set(want)) > 1


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_co_tuning_never_infeasible(seed):
    eng = _engine("hasfl", n_clients=12, seed=seed, local_steps=1)
    eng.run_round()
    fleet, strat = eng.state.fleet, eng.strategy
    assert (fleet.depths >= 1).all()
    assert (fleet.depths <= fleet.capacity).all()
    assert fleet.feasible.all()
    assert set(strat._bs.tolist()) <= set(strat.batch_choices)


def test_subcohorts_chain_server_moments():
    """Every same-depth (batch) group steps the shared server branch:
    AdamW's step count is local_steps x the number of (depth, batch)
    groups."""
    eng = _engine(HASFL(time_budget_factor=1.1), optimizer="adamw",
                  lr=0.01, availability=1.0)
    eng.run_round()
    fleet, strat = eng.state.fleet, eng.strategy
    groups = {(int(d), int(b)) for d, b in zip(fleet.depths, strat._bs)}
    assert len(groups) > len(set(fleet.depths.tolist()))
    assert int(eng.state.opt_state["server"]["t"]) == \
        eng.local_steps * len(groups)
