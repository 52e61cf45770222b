"""The port's arrival processes, staleness weighting, the HASFL cost model
and the ``unstable`` strategy against the live JAX package, plus the
engine surfaces the scenario strategies brought (the legacy batch path,
the ``FederatedTrainer`` shim, the older hook signatures).

Exact: ``MarkovArrivalProcess`` and ``TimeoutAvailability`` draws and
their state round trip (across the packages too), ``staleness_weights``,
``estimate_step_time_s`` and ``co_tune`` (depths, batches, widths), the
legacy batches. ``unstable`` at the ``tests/_torch_parity.py`` setting
(reduced ViT, 6 clients, seed 0, the reference's weights), at its
defaults and at gamma 0, with ``use_pallas`` off and on: round losses
1e-5, cost-model records exactly, final params and server moments 1e-4,
the streams, the staleness vector and the Markov state exactly. Within
the port: the frozen server and resume bit for bit. The two examples of
the slice run on the CPU: ``quickstart_torch.py`` with each scenario
strategy and ``fault_tolerance_torch.py``'s sweep.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402

from repro.core import allocation as JAL  # noqa: E402
from repro.core import fault as JF  # noqa: E402
from repro.federated.strategies.unstable import (  # noqa: E402
    staleness_weights as j_staleness_weights)

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import allocation as TAL  # noqa: E402
from repro_torch.core import fault as TF  # noqa: E402
from repro_torch.federated import (Engine as TEngine,  # noqa: E402
                                   FederatedTrainer, available_strategies,
                                   get_strategy)
from repro_torch.federated.strategies import (  # noqa: E402
    SuperSFL, UnstableParticipation, staleness_weights)
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cfg():
    return TB.get_reduced("vit16_cifar").replace(**P.SMALL)


def _engine(strategy, n_clients=6, **kw):
    return TEngine(_cfg(), n_clients, strategy, device="cpu",
                   **dict(P.ARGS, **kw))


def _flat(tree):
    return dict(tree_flatten_with_path(tree))


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# ------------------------------------------------------- arrival processes

MARKOV = [dict(p_up=0.4, p_down=0.2, straggle_p=0.1, seed=21),
          dict(p_up=0.1, p_down=0.3, straggle_p=0.0, seed=3),
          dict(p_up=1.0, p_down=0.0, straggle_p=0.5, seed=7),
          dict(p_up=0.9, p_down=0.9, straggle_p=0.2, seed=0)]


@pytest.mark.parametrize("kw", MARKOV, ids=str)
def test_markov_draws_match_reference(kw):
    """Draw for draw, including the lazy stationary start and a restart
    when the fleet size changes."""
    j, t = JF.MarkovArrivalProcess(**kw), TF.MarkovArrivalProcess(**kw)
    assert t.stationary_fraction == j.stationary_fraction
    for n in (8, 8, 8, 5, 5, 16, 16):
        a, b = j.draw(n), t.draw(n)
        assert b.dtype == np.bool_
        np.testing.assert_array_equal(b, a)
    assert t.get_state() == j.get_state()


@pytest.mark.parametrize("direction", ["port->reference", "reference->port"])
def test_markov_state_crosses_packages(direction):
    kw = MARKOV[0]
    src = (TF if direction.startswith("port") else JF).MarkovArrivalProcess(
        **kw)
    for _ in range(4):
        src.draw(12)
    dst = (JF if direction.startswith("port") else TF).MarkovArrivalProcess(
        **dict(kw, seed=99))
    assert dst.get_state()["up"] is None
    dst.set_state(src.get_state())
    assert len(dst.get_state()["up"]) == 12
    for _ in range(5):
        np.testing.assert_array_equal(dst.draw(12), src.draw(12))


def test_markov_fresh_state_has_no_chain():
    a = TF.MarkovArrivalProcess(0.4, 0.2, seed=1)
    b = TF.MarkovArrivalProcess(0.4, 0.2, seed=1)
    b.draw(4)
    b.set_state(a.get_state())
    assert b._up is None
    np.testing.assert_array_equal(b.draw(4), a.draw(4))


@pytest.mark.parametrize("jitter", [0.0, 25.0])
def test_timeout_availability_matches_reference(jitter):
    lat = np.random.default_rng(2).uniform(20.0, 200.0, 10)
    j = JF.TimeoutAvailability(lat, 120.0, jitter_ms=jitter, seed=5)
    t = TF.TimeoutAvailability(lat, 120.0, jitter_ms=jitter, seed=5)
    for n in (10, 10, 7):
        np.testing.assert_array_equal(t.draw(n), j.draw(n))
    assert t.get_state() == j.get_state()
    if jitter == 0.0:
        np.testing.assert_array_equal(t.draw(10), lat <= 120.0)


# ------------------------------------------------------ staleness weights

def test_staleness_weights_match_reference():
    rng = np.random.default_rng(0)
    cases = [(rng.random(7), rng.integers(0, 6, 7), g, m)
             for g in (0.0, 0.5, 1.0, 2.0)
             for m in (None, rng.random(7) < 0.6)]
    cases += [(np.zeros(4), np.arange(4), 1.0, None),            # uniform
              (np.zeros(4), np.arange(4), 1.0,
               np.array([True, False, True, False])),             # on mask
              (np.array([0.5, 0.5]), np.array([0, 3]), 1.0, None)]
    for w, s, g, m in cases:
        got = staleness_weights(w, s, g, mask=m)
        want = j_staleness_weights(w, s, g, mask=m)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    w = staleness_weights(np.array([0.5, 0.5]), np.array([0, 3]))
    assert w[0] == pytest.approx(4 * w[1])   # (1 + 3)^-1


# --------------------------------------------------- the HASFL cost model

def _cost_inputs(seed, n=9, L=12):
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0], np.cumsum(rng.integers(10**5, 10**7, L))])
    return dict(capacity=rng.integers(1, L, n),
                mem_gb=rng.uniform(2.0, 16.0, n),
                lat_ms=rng.uniform(20.0, 200.0, n),
                client_params_by_depth=counts,
                tokens_per_sample=int(rng.choice([16, 64, 256])),
                bytes_per_sample=int(rng.integers(10**3, 10**6)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_step_time_matches_reference(seed):
    kw = _cost_inputs(seed)
    d, b = np.arange(1, 9), np.array([4, 8, 16, 32, 4, 8, 16, 32])
    args = (d, b, kw["mem_gb"][:8], kw["lat_ms"][:8],
            kw["client_params_by_depth"], kw["tokens_per_sample"],
            kw["bytes_per_sample"])
    for opts in ({}, dict(gflops_per_mem=3.0, bandwidth_mb_s=5.0)):
        np.testing.assert_array_equal(
            TAL.estimate_step_time_s(*args, **opts),
            JAL.estimate_step_time_s(*args, **opts))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tiers", [None, (0.25, 0.5, 0.75, 1.0), (1.0, 0.5)])
def test_co_tune_matches_reference(seed, tiers):
    kw = _cost_inputs(seed)
    for opts in (dict(), dict(time_budget_factor=0.3, base_batch=32),
                 dict(time_budget_factor=2.5, batch_choices=(2, 8)),
                 dict(time_budget_factor=0.05, bandwidth_mb_s=2.0)):
        got = TAL.co_tune(**kw, width_tiers=tiers, **opts)
        want = JAL.co_tune(**kw, width_tiers=tiers, **opts)
        assert len(got) == len(want) == (2 if tiers is None else 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (got[0] >= 1).all() and (got[0] <= kw["capacity"]).all()


def test_co_tune_checks_its_inputs():
    kw = _cost_inputs(0)
    with pytest.raises(ValueError):
        TAL.co_tune(**kw, batch_choices=())
    with pytest.raises(ValueError):
        TAL.co_tune(**kw, width_tiers=(0.0, 1.0))


# ----------------------------------------------------- the unstable round

CASES = {"defaults": {}, "gamma=0": dict(gamma=0.0)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def reference(case):
    from repro.federated.strategies.unstable import \
        UnstableParticipation as JU
    ref = P.run_reference(JU(**CASES[case]))
    eng = ref["engine"]
    ref["staleness"] = eng._staleness.copy()
    ref["markov"] = eng.participation.get_state()
    return ref


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, case, reference):
    return P.run_port(reference, request.param,
                      UnstableParticipation(**CASES[case]))


def test_unstable_records_match(reference, port):
    P.assert_records_match(reference, port)


def test_unstable_params_and_server_match(reference, port):
    P.assert_params_and_server_match(reference, port)


def test_unstable_streams_staleness_and_chain_match(reference, port):
    P.assert_streams_match(reference, port)
    eng = port["engine"]
    np.testing.assert_array_equal(eng._staleness, reference["staleness"])
    assert eng.participation.get_state() == reference["markov"]
    assert eng._staleness.max() >= 1     # somebody sat a round out
    assert eng.evaluate(head="global") == reference["acc_global"]


def test_unstable_is_registered_with_its_chain():
    eng = _engine("unstable", n_clients=4)
    assert isinstance(eng.strategy, UnstableParticipation)
    assert isinstance(eng.participation, TF.MarkovArrivalProcess)
    proc = TF.MarkovArrivalProcess(0.9, 0.05, seed=5)
    assert _engine("unstable", n_clients=4, participation=proc) \
        .participation is proc


def test_every_reference_strategy_is_registered():
    names = ["async_buffered", "dfl", "fedadam", "fedavg", "fedavgm",
             "fedyogi", "hasfl", "sfl", "ssfl", "unstable"]
    assert available_strategies() == names
    for n in names:
        assert get_strategy(n).name == n
    with pytest.raises(KeyError):
        get_strategy("nope")


def test_unstable_resume_is_bit_identical(tmp_path):
    """2 rounds == 1 round + save + a fresh engine + restore + 1 round:
    params, heads, the server moments, staleness and the Markov chain."""
    mk = lambda: _engine("unstable", optimizer="adamw", lr=0.01,
                         availability=0.7)
    a = mk()
    a.run_round()
    a.run_round()
    b = mk()
    b.run_round()
    b.save(str(tmp_path / "ck"))
    c = mk()
    c.restore(str(tmp_path / "ck"))
    assert c.participation.get_state() == b.participation.get_state()
    np.testing.assert_array_equal(c._staleness, b._staleness)
    assert c.run_round()["loss"] == a.history[-1]["loss"]
    for part in ("params", "local_heads", "opt_state"):
        _assert_trees_equal(getattr(a.state, part), getattr(c.state, part))
    assert a.participation.get_state() == c.participation.get_state()


def test_unstable_frozen_server_is_bit_exact():
    """Server unreachable from round 0: the server-side leaves and the
    server moments do not move, bit for bit, while clients train."""
    eng = _engine("unstable", optimizer="adamw", lr=0.05, availability=0.0)
    head = eng.state.params["head"].clone()
    embed = eng.state.params["patch_embed"].clone()
    for _ in range(3):
        rec = eng.run_round()
    assert np.isfinite(rec["loss"])
    assert torch.equal(head, eng.state.params["head"])
    assert int(eng.state.opt_state["server"]["t"]) == 0
    assert not torch.equal(embed, eng.state.params["patch_embed"])


# ------------------------------------- the legacy surfaces of the engine

def test_batch_fn_draws_what_sample_indices_draws():
    """The legacy host path (``RoundContext.batch_fn``, one call per local
    step) and ``sample_indices`` consume the same draws: two engines of
    one seed give the same pixels and labels."""
    a, b = _engine("ssfl"), _engine("ssfl")
    ids = np.array([4, 0, 3])
    idx = torch.as_tensor(a._sample_indices(ids, 2, 5).astype(np.int64))
    dd = a.device_data
    for t in range(2):
        batch = b._stack_batches(ids, batch_size=5)
        assert batch["images"].shape == (3, 5, 16, 16, 3)
        assert batch["label"].dtype == torch.int64
        assert torch.equal(batch["images"], dd.images[idx[t]])
        assert torch.equal(batch["label"], dd.labels[idx[t]])
    assert a.state.rng.bit_generator.state == \
        b.state.rng.bit_generator.state
    seen = []
    b.strategy.init_round = lambda eng, ctx: seen.append(ctx.batch_fn) or {}
    b.strategy.cohorts = lambda eng, ctx: {}
    b.strategy.aggregate = lambda eng, ws: (eng.state.params, 0.0)
    b.run_round()
    assert seen[0] == b._stack_batches


def test_federated_trainer_shim_matches_the_engine():
    cfg = _cfg()
    tr = FederatedTrainer(cfg, 4, "ssfl", lr=0.3, batch_size=8,
                          device="cpu")
    eng = TEngine(cfg, 4, "ssfl", lr=0.3, batch_size=8, device="cpu")
    assert tr.method == "ssfl" and tr.batch_size == 8 and tr.lr == 0.3
    assert len(tr.local_heads) == 4 and tr.fleet is tr.engine.state.fleet
    for _ in range(2):
        assert tr.run_round()["loss"] == eng.run_round()["loss"]
    assert tr.rng.bit_generator.state == eng.state.rng.bit_generator.state
    _assert_trees_equal(tr.params, eng.state.params)
    assert tr.evaluate(1) == eng.evaluate(1)
    with pytest.raises(ValueError):
        FederatedTrainer(cfg, 4, "hasfl", device="cpu")


def test_federated_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FederatedTrainer(_cfg(), 3)


def test_older_hook_signatures_still_run():
    """A strategy written against the two-argument ``prepare_fleet`` and
    the three-argument ``comm_cost`` constructs and runs; the engine
    prices every client with the shared scalars."""
    class Legacy(SuperSFL):
        def prepare_fleet(self, cfg, fleet):
            self.saw_fleet = fleet.n_clients

        def comm_cost(self, engine, d, available):
            return 1000, 4

    eng = _engine(Legacy(), n_clients=3)
    assert eng.strategy.saw_fleet == 3
    assert np.isfinite(eng.run_round()["loss"])
    assert eng.accountant.rounds[-1].comm_bytes == 3 * 1000
    assert eng.accountant.rounds[-1].n_messages == 3 * 4


# ----------------------------------------------------------- the examples

def _example(monkeypatch, capsys, name, *args):
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("strategy", ["unstable", "async_buffered", "hasfl"])
def test_quickstart_example_runs_every_scenario(monkeypatch, capsys,
                                                strategy):
    out = _example(monkeypatch, capsys, "quickstart_torch.py", "--device",
                   "cpu", "--rounds", "2", "--clients", "4", "--strategy",
                   strategy)
    assert "round  2" in out and "ledger:" in out
    assert "async_buffered" in out.splitlines()[0]


def test_fault_tolerance_example_prints_the_sweep(monkeypatch, capsys):
    out = _example(monkeypatch, capsys, "fault_tolerance_torch.py", "1",
                   "--device", "cpu", "--clients", "3")
    rows = [ln.split() for ln in out.splitlines()[1:]]
    assert [r[0] for r in rows] == ["1.0", "0.7", "0.5", "0.2", "0.0"]
    assert all(0.0 <= float(r[-1]) <= 1.0 for r in rows)
