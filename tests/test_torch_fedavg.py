"""The FedAvg family of the port — ``fedavg``, ``fedavgm``, ``fedadam``,
``fedyogi`` — against a live JAX ``Engine`` (``tests/_torch_parity.py``:
reduced ViT, 6 clients, seed 0, lr 0.3, 2 local steps, batch 8,
availability 0.8), both started from the same weights, with
``use_pallas`` off and on (no port kernel lies on this path, so both
run the same code).

Held: round losses 1e-5, cost-model records exactly, final params and the
server slot 1e-4 (round 2 of the adaptive members included: at this
setting they sit within 1.1e-7 of the reference), the streams exactly.
``FedAvg(server_momentum=0.0)`` takes the no-fold path: float-identical
to ``fedavg``, and no server slot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated import get_strategy  # noqa: E402
from repro_torch.federated.strategies import FedAvg  # noqa: E402
from repro_torch.optim import sgd_momentum  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

SLOTS = {"fedavg": None, "fedavgm": ["mu"], "fedadam": ["m", "v"],
         "fedyogi": ["m", "v"]}


@pytest.fixture(scope="module", params=sorted(SLOTS))
def name(request):
    return request.param


@pytest.fixture(scope="module")
def reference(name):
    return P.run_reference(name)


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, name, reference):
    return P.run_port(reference, request.param, name)


def test_two_round_records_match(reference, port):
    P.assert_records_match(reference, port)


def test_final_params_and_server_slot_match(reference, port):
    P.assert_params_and_server_match(reference, port)


def test_fleet_availability_and_batches_match(reference, port):
    P.assert_streams_match(reference, port)
    assert (port["engine"].state.fleet.depths == 4).all()   # the full stack


def test_server_slot_holds_the_reference_entries(name, reference, port):
    opt = port["engine"].state.opt_state
    ref = reference["engine"].state.opt_state
    if SLOTS[name] is None:
        assert "server" not in opt and "server" not in ref
        return
    assert sorted(opt["server"]) == sorted(ref["server"]) == SLOTS[name]
    for k in SLOTS[name]:
        assert all(x.dtype == torch.float32 for _, x in
                   tree_flatten_with_path(opt["server"][k]))
    assert any(x.abs().sum() > 0 for _, x in
               tree_flatten_with_path(opt["server"]))


def _cpu_engine(strategy, n_clients=4):
    cfg = TB.get_reduced("vit16_cifar").replace(**P.SMALL)
    return TEngine(cfg, n_clients, strategy, device="cpu", seed=0, lr=0.3,
                   local_steps=2, batch_size=8)


def test_zero_momentum_is_exact_fedavg():
    a = _cpu_engine("fedavg")
    b = _cpu_engine(FedAvg(server_momentum=0.0))
    for _ in range(2):
        assert a.run_round()["loss"] == b.run_round()["loss"]
    assert "server" not in b.state.opt_state
    for (p, x), (_, y) in zip(tree_flatten_with_path(a.state.params),
                              tree_flatten_with_path(b.state.params)):
        assert torch.equal(x, y), p


def test_strategy_instances_and_server_options():
    eng = (TEngine.builder(TB.get_reduced("vit16_cifar").replace(**P.SMALL))
           .clients(3).strategy(FedAvg(server_opt=sgd_momentum(1.0, 0.5)))
           .execution(device="cpu").build())
    assert isinstance(eng.strategy, FedAvg)
    assert np.isfinite(eng.run_round()["loss"])
    assert sorted(eng.state.opt_state["server"]) == ["mu"]
    with pytest.raises(ValueError, match="either"):
        FedAvg(server_momentum=0.9, server_opt=sgd_momentum(1.0, 0.5))
    for n in ("sfl", "dfl", "fedavg", "fedavgm", "fedadam", "fedyogi"):
        assert get_strategy(n).name == n
