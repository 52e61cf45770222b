"""The port's meshes: ``DeviceMesh``es over the ranks of the
``torch.distributed`` process group.

* The fleet mesh, a 1-D ``("data",)`` mesh for ``Engine(mesh=...)``.
* The LM meshes, 2-D ``("data", "model")`` (3-D ``("pod", "data",
  "model")`` for multi-pod) for the sharded LM steps
  (``launch.sharding``'s LM section): ``make_production_mesh``,
  ``make_test_mesh``, and ``make_abstract_mesh``, a device-free stand-in
  that carries only axis names and sizes, for the spec rules.

The counterpart of the JAX package's ``launch/mesh.py::make_fleet_mesh``.
There one process drives every device of the host; here each device (or
each share of one) is a rank of its own process, and the mesh names the
process group that the fleet's collectives run in
(``launch.sharding.fleet_group``). Start the ranks first (one process
each, ``init_process_group`` with an address, the world size and the
rank), then call this on every rank::

    torch.distributed.init_process_group(
        "gloo", init_method="file:///tmp/fleet-store", world_size=2,
        rank=rank)
    mesh = make_fleet_mesh(2, device="cpu")
    engine = Engine(cfg, 13, "ssfl", mesh=mesh, device="cpu")

``make_fleet_mesh(1)`` with no process group makes a one-rank group in
this process, as ``make_fleet_mesh(1)`` works in one JAX process; an
extent-1 mesh runs the meshless engine's code path exactly.

Nothing here runs at import time.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device

FLEET_AXIS = "data"
BACKENDS = ("nccl", "gloo")
TENSOR_AXIS = "model"


def make_fleet_mesh(n_devices: int = None, *, device=None,
                    backend: str = None):
    """A 1-D ``DeviceMesh`` named ``("data",)`` over the process group's
    ranks, on ``device``'s type (None: the card, see
    ``repro_torch.device.resolve_device``; ``"cpu"`` for CPU ranks).

    ``backend`` ("nccl" or "gloo"; default: nccl on the card, gloo on the
    CPU) is the backend of the one-rank group made when no group exists,
    and otherwise must be the existing group's. Two ranks that share one
    card need gloo: NCCL refuses two ranks on one device. ``n_devices``
    (None: every rank) must equal the world size; a world smaller than
    asked raises, as the reference does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        # the rank's card, before the mesh picks one by its own heuristic
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"fleet mesh wants {n_devices} ranks and no process group "
                "is initialized: start one process per rank and call "
                "torch.distributed.init_process_group in each first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"backend={backend!r}, but the process group runs "
                         f"{dist.get_backend()!r}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise RuntimeError(f"fleet mesh wants {n} ranks, found {world}")
    if n != world:
        raise ValueError(f"fleet mesh wants {n} ranks of a world of {world}: "
                         "a fleet mesh spans every rank of the process "
                         "group")
    return DeviceMesh(dev.type, list(range(n)),
                      mesh_dim_names=(FLEET_AXIS,))


# ---------------------------------------------------------- the LM meshes

class AbstractMesh:
    """Axis names and sizes, no devices: what the spec rules of
    ``launch.sharding`` read (the reference's ``jax.sharding.
    AbstractMesh``). ``shape`` maps each axis name to its size."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A device-free mesh for sharding-rule validation."""
    return AbstractMesh(tuple(shape), tuple(axes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def fsdp_axes(mesh) -> tuple:
    """The axes FSDP (and the batch) shard over: ``("pod", "data")`` on a
    multi-pod mesh, else ``("data",)``."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_axes(mesh) -> tuple:
    return fsdp_axes(mesh)


def _lm_mesh(shape, axes, device, what: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    process group (``prod(shape)`` of them), on ``device``'s type.
    A one-rank mesh with no group makes its own one-rank group, as
    ``make_fleet_mesh(1)`` does. DTensor's collectives on CUDA tensors
    need NCCL: a gloo group on the card raises (gloo runs only
    ``all_reduce`` and ``broadcast`` on CUDA tensors)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"{what} {tuple(shape)} needs {n} ranks and no process "
                "group is initialized: start one process per rank (e.g. "
                "under torchrun) and call torch.distributed."
                "init_process_group in each first, or run the dry-run "
                "(python -m repro_torch.launch.dryrun), which starts a "
                "fake process group of 256 or 512 ranks itself")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = dist.get_backend()
    if dev.type == "cuda" and backend == "gloo":
        raise ValueError(
            f"{what} on {dev} over a gloo process group: gloo runs only "
            "all_reduce and broadcast on CUDA tensors, and DTensor's "
            "redistributions need all_gather and reduce_scatter too; use "
            "NCCL, one rank a card")
    if dev.type != "cuda" and backend == "nccl":
        raise ValueError(f"{what} on {dev} over an NCCL process group: "
                         "NCCL runs only on CUDA devices")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"{what} {tuple(shape)} needs {n} ranks, found {world}; run "
            "the dry-run (python -m repro_torch.launch.dryrun) for the "
            "production meshes, which starts a fake process group of 256 "
            "or 512 ranks itself")
    if world != n:
        raise ValueError(f"{what} {tuple(shape)} wants {n} ranks of a "
                         f"world of {world}: an LM mesh spans every rank "
                         "of the process group")
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(dev.index if dev.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, over the
    process group's ranks on ``device``'s type (None: the card). Raises
    below 256 (512) ranks, pointing at the dry-run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _lm_mesh(shape, axes, device, "production mesh")


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   device=None):
    """A small LM mesh over the world's ``prod(shape)`` ranks: what the
    cards and the CPU tests run (``(1, 1)`` runs in one process)."""
    return _lm_mesh(tuple(shape), tuple(axes), device, "test mesh")
