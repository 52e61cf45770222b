"""The port's public constructors run on the card unless told otherwise:
``init_params``, ``init_local_head``, ``init_cache``,
``init_train_state``, ``bridge.to_model_params`` and ``bridge.to_torch``
resolve ``device=None`` to CUDA and, without a card, raise and ask for
``device="cpu"``; asked for the CPU they build there. (``Engine`` is
held to the same rule by ``tests/test_torch_engine.py``.) So does
``launch.mesh.make_fleet_mesh``, before it makes any process group (its
CPU meshes are built by ``tests/_torch_multidevice_child.py``)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated import engine as TE  # noqa: E402
from repro_torch.federated.state import init_train_state  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _constructors():
    vit = TB.get_reduced("vit16_cifar")
    gen = torch.Generator().manual_seed(0)
    llama = TB.get_reduced("llama3_2_3b")
    np_params = bridge.to_numpy(TM.init_params(llama, gen, device="cpu"))
    return {
        "init_params": lambda **kw: TM.init_params(
            TB.get_reduced("mamba2_2_7b"), gen, **kw),
        "init_local_head": lambda **kw: TM.init_local_head(vit, gen, **kw),
        "init_cache": lambda **kw: TD.init_cache(
            TB.get_reduced("hymba_1_5b"), 2, 8, **kw),
        "init_train_state": lambda **kw: (lambda st: [
            st.params, st.local_heads])(init_train_state(vit, 3, **kw)),
        "to_model_params": lambda **kw: bridge.to_model_params(
            llama, np_params, **kw),
        "to_torch": lambda **kw: bridge.to_torch(np_params, **kw),
    }


@pytest.mark.parametrize("name", ["init_params", "init_local_head",
                                  "init_cache", "init_train_state",
                                  "to_model_params", "to_torch"])
def test_constructors_default_to_the_card(monkeypatch, name):
    make = _constructors()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    built = make(device="cpu")
    tensors = [x for x in tree_leaves(built) if isinstance(x, torch.Tensor)]
    assert tensors and all(x.device.type == "cpu" for x in tensors)


def test_resolve_device_is_the_engines():
    assert TE.resolve_device is resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("meta") == torch.device("meta")


def test_make_fleet_mesh_defaults_to_the_card(monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fleet_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_fleet_mesh(1)
    assert not dist.is_initialized()
