"""The SplitFed baselines ``sfl`` and ``dfl`` of the port against a live
JAX ``Engine`` (``tests/_torch_parity.py``: reduced ViT, 6 clients, seed
0, lr 0.3, 2 local steps, batch 8, availability 0.8), both started from
the same weights.

Cases: ``sfl`` and ``dfl`` at full width, ``dfl`` on the width ladder
(0.25, 0.5, 0.75, 1.0: two chained width groups in a cohort), and
``sfl`` with ``adamw`` (lr 0.01: server moments and their step count
chained, gated and fed-averaged), each with ``use_pallas`` off and on
(on the CPU the ``aggregate`` wrapper takes its plain version; departure
(a)). Held: round losses 1e-5, cost-model records exactly, final params
and server moments 1e-4, fleet, availability and batch streams exactly,
and the global head's accuracy exactly. With the server unreachable, the
per-client server copies and the server moments stay bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core.fault import AvailabilityModel  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated.strategies import splitfed  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

CASES = {
    "sfl": dict(strategy="sfl"),
    "dfl": dict(strategy="dfl"),
    "dfl-ladder": dict(strategy="dfl", width_tiers=P.LADDER),
    "sfl-adamw": dict(strategy="sfl", optimizer="adamw", lr=0.01),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def reference(case):
    return P.run_reference(**CASES[case])


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, case, reference):
    return P.run_port(reference, request.param, **CASES[case])


def test_two_round_records_match(reference, port):
    P.assert_records_match(reference, port)


def test_final_params_and_server_moments_match(reference, port):
    P.assert_params_and_server_match(reference, port)


def test_fleet_availability_and_batches_match(case, reference, port):
    P.assert_streams_match(reference, port)
    fleet = port["engine"].state.fleet
    if case.startswith("sfl"):
        assert (fleet.depths == 2).all()     # mid-stack of the 4 layers
    if case == "dfl-ladder":
        # some depth cohort holds two width groups, which chain
        assert any(len(set(fleet.widths[ids])) > 1
                   for ids in fleet.cohorts().values())


def test_evaluate_matches(reference, port):
    assert port["engine"].evaluate(head="global") == reference["acc_global"]


def test_comm_cost_is_one_shared_scalar(port):
    eng = port["engine"]
    d = int(eng.state.fleet.depths[0])
    nbytes, msgs = eng.strategy.comm_cost(eng, d, True, np.arange(3))
    assert isinstance(nbytes, int) and isinstance(msgs, int) and nbytes > 0
    assert eng.strategy.comm_cost(eng, d, False, np.arange(3))[0] == 0


def test_stalled_clients_leave_server_copies_and_moments_bit_exact():
    """With the server unreachable every client of the round is stalled:
    each per-client server copy comes back as the round's server branch,
    bit for bit, the client rows are the downloaded ones, and the server
    moments (made non-zero by a live round first) do not move, step count
    included."""
    cfg = TB.get_reduced("vit16_cifar").replace(**P.SMALL)
    eng = TEngine(cfg, 5, "sfl", device="cpu", optimizer="adamw", lr=0.01,
                  local_steps=2, batch_size=8, availability=1.0)
    eng.run_round()
    srv = eng.state.opt_state["server"]
    moments = {p: x.clone() for p, x in tree_flatten_with_path(srv)}
    assert int(srv["t"]) == 2 and any(x.abs().sum() > 0
                                      for x in moments.values())
    params = {p: x.clone() for p, x in
              tree_flatten_with_path(eng.state.params)}
    heads = {p: x.clone() for p, x in
             tree_flatten_with_path(eng.state.local_heads)}
    d = int(eng.state.fleet.depths[0])
    seen = []
    fold = eng.strategy.fold_server

    def spy(engine, ws, d_, ids, res):
        seen.append((res.payload, ws["client_stack"], ids))
        return fold(engine, ws, d_, ids, res)

    eng.strategy.fold_server = spy
    eng.avail_model = AvailabilityModel(0.0)
    rec = eng.run_round()
    assert np.isfinite(rec["loss"])
    (groups, stack, ids), = seen
    for copies in groups:
        for copy in copies:
            for path, x in tree_flatten_with_path(copy):
                want = params[path] if path[0] != "layers" \
                    else params[path][d:]
                assert torch.equal(x, want), path
    for path, x in tree_flatten_with_path(stack["layers"]):
        for i in ids:
            assert torch.equal(x[i, :d], params[("layers",) + path][:d]), \
                path
    for path, x in tree_flatten_with_path(eng.state.opt_state["server"]):
        assert torch.equal(x, moments[path]), path
    for path, x in tree_flatten_with_path(eng.state.local_heads):
        assert torch.equal(x, heads[path]), path


def test_sfl_and_dfl_weights():
    mask = np.array([True, False, True, True])
    depths = np.array([2, 2, 1, 3])
    np.testing.assert_allclose(splitfed.SplitFed().client_weights(
        depths, mask), [1 / 3, 0, 1 / 3, 1 / 3], rtol=1e-6)
    np.testing.assert_allclose(splitfed.DynamicSplitFed().client_weights(
        depths, mask), [2 / 6, 0, 1 / 6, 3 / 6], rtol=1e-6)
