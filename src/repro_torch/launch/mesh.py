"""The fleet mesh: a 1-D ``("data",)`` ``DeviceMesh`` over the ranks of
the ``torch.distributed`` process group, for ``Engine(mesh=...)``.

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

import torch

from repro_torch.device import resolve_device

FLEET_AXIS = "data"
BACKENDS = ("nccl", "gloo")


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
