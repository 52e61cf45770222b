"""The fleet (client) axis over a ``launch.mesh.make_fleet_mesh`` mesh:
which rank owns which client, and the few collectives the engine's
strategies need.

The counterpart of the fleet section of the JAX package's
``launch/sharding.py`` (``fleet_axes``, ``fleet_extent``,
``fleet_pspecs``, ``shard_fleet``) and of its sharded slot reductions
(``federated/bucketing.py``: ``slot_sum``, ``masked_slot_mean``,
``freeze_gate``). Every fleet collective of the port runs here, in
:func:`fleet_group`'s group, and uses only ``all_reduce`` and
``broadcast``: the two collectives that gloo runs on CUDA tensors too.
fleetlint's FL003 holds the rest of the port to that.

Ownership (departure (h)): client ``i`` lives on rank ``fleet_owner(i)``,
the contiguous ``np.array_split`` blocks of ``range(N)``: its local head,
its workspace row and its ``sfl`` server copy never move. The reference
shards bucket slots for compute and replicates storage when ``N`` does
not divide the extent, and XLA moves the data between those layouts;
both compute the same function, only the order of the fp32 sums differs.

Every helper is the identity on a mesh of extent 1 (or ``mesh=None``)
and runs no collective there.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_path, tree_map, tree_rebuild

_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMED = {"on": False}


# ----------------------------------------------------------------- the axis

def fleet_group(mesh):
    """The process group of every fleet collective: the mesh's ``"data"``
    dimension (the counterpart of ``fleet_axes``)."""
    return mesh.get_group("data")


def fleet_extent(mesh) -> int:
    """Number of ranks the fleet splits over (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size())


def fleet_rank(mesh) -> int:
    """This process's position on the fleet axis (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank("data"))


def _block_sizes(n_clients: int, mesh) -> List[int]:
    """Clients per rank: the ``np.array_split`` blocks of ``range(N)``
    (the first ``N % R`` ranks hold one client more). The one place the
    layout of departure (h) is decided."""
    return [len(b) for b in np.array_split(np.arange(n_clients),
                                           fleet_extent(mesh))]


def fleet_owner(n_clients: int, mesh) -> np.ndarray:
    """[N] int: the rank that owns each client (contiguous blocks)."""
    return np.repeat(np.arange(fleet_extent(mesh)),
                     _block_sizes(n_clients, mesh))


def owned_range(n_clients: int, mesh) -> Tuple[int, int]:
    """``(lo, hi)``: this rank owns clients ``lo .. hi - 1``."""
    sizes = _block_sizes(n_clients, mesh)
    r = fleet_rank(mesh)
    lo = int(sum(sizes[:r]))
    return lo, lo + sizes[r]


def shard_fleet(tree, n_clients: int, mesh):
    """This rank's owned rows of an ``[N]``-leading tree, as tensors of
    their own (the full tree may be freed); the tree itself at extent 1."""
    if fleet_extent(mesh) == 1:
        return tree
    lo, hi = owned_range(n_clients, mesh)
    return tree_map(lambda x: x[lo:hi].clone(), tree)


# ------------------------------------------------------------- collectives

def collective_stats(reset: bool = False) -> Dict[str, float]:
    """Calls, bytes and (with :func:`time_collectives`) seconds of the
    fleet collectives this process ran; ``reset`` zeroes them after
    reading."""
    out = dict(_STATS)
    if reset:
        _STATS.update(calls=0, bytes=0, seconds=0.0)
    return out


def time_collectives(on: bool) -> None:
    """With ``on``, each collective synchronises its device first and
    adds its own wall to ``collective_stats()["seconds"]``; off (the
    default), nothing is timed and nothing synchronised."""
    _TIMED["on"] = bool(on)


def _all_reduce(buf: torch.Tensor, mesh, op=None) -> torch.Tensor:
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    t0 = None
    if _TIMED["on"]:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=fleet_group(mesh))
    if t0 is not None:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        _STATS["seconds"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += buf.numel() * buf.element_size()
    return buf


def fleet_sum(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor summed over the ranks (every rank passes the same
    shapes and dtypes, in the same order): one ``all_reduce`` per dtype
    over the tensors laid end to end. Returns new tensors (the inputs at
    extent 1). Every rank gets the same bits."""
    tensors = list(tensors)
    if fleet_extent(mesh) == 1 or not tensors:
        return tensors
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for k, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(k)
    for ks in by_dtype.values():
        flat = _all_reduce(torch.cat([tensors[k].reshape(-1) for k in ks]),
                           mesh)
        start = 0
        for k in ks:
            n = tensors[k].numel()
            out[k] = flat[start:start + n].view(tensors[k].shape)
            start += n
    return out


def fleet_sum_tree(tree, mesh):
    """:func:`fleet_sum` over the leaves of a tree."""
    if fleet_extent(mesh) == 1:
        return tree
    flat = tree_flatten_with_path(tree)
    summed = fleet_sum([x for _, x in flat], mesh)
    return tree_rebuild(tree, {p: x for (p, _), x in zip(flat, summed)})


def fleet_any(flags: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise "any" of a bool tensor over the ranks (the freeze
    gate's and the sanitizer's reduction)."""
    if fleet_extent(mesh) == 1:
        return flags
    return _all_reduce(flags.to(torch.int32), mesh) > 0


def fleet_gather(tree, n_clients: int, mesh):
    """The ``[N]``-leading tree whose rows ``lo .. hi - 1`` are this
    rank's ``[hi - lo]``-leading ``tree``, every rank's rows in place,
    bit for bit: each rank writes the bytes of its rows into a zeroed
    buffer, and one ``all_reduce`` sums the buffers as bytes (exactly one
    rank holds each byte, so the sum is that byte)."""
    if fleet_extent(mesh) == 1:
        return tree
    lo, hi = owned_range(n_clients, mesh)
    flat = tree_flatten_with_path(tree)
    parts, shapes = [], []
    for _, x in flat:
        full = torch.zeros((n_clients,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[lo:hi] = x
        raw = full.reshape(-1).view(torch.uint8)
        # each leaf starts 8-byte aligned, so its bytes view back as it
        pad = -raw.numel() % 8
        parts += [raw, raw.new_zeros(pad)]
        shapes.append((full.shape, full.dtype, raw.numel() + pad))
    buf = _all_reduce(torch.cat(parts), mesh)
    out, start = {}, 0
    for (path, _), (shape, dtype, nbytes) in zip(flat, shapes):
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out[path] = buf[start:start + n].view(dtype).view(shape)
        start += nbytes
    return tree_rebuild(tree, out)


def fleet_broadcast(tree, src: int, mesh):
    """Rank ``src``'s leaves on every rank, in place (the leaves of every
    rank must have the same shapes and dtypes). Returns ``tree``."""
    if fleet_extent(mesh) == 1:
        return tree
    import torch.distributed as dist
    group = fleet_group(mesh)
    for _, x in tree_flatten_with_path(tree):
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
        _STATS["calls"] += 1
        _STATS["bytes"] += x.numel() * x.element_size()
    return tree


def fleet_barrier(mesh) -> None:
    """Return on every rank only once every rank has reached this call:
    a one-element ``all_reduce``."""
    if fleet_extent(mesh) > 1:
        _all_reduce(torch.zeros(1, device=mesh.device_type), mesh)


def replicated_drift(tree, mesh) -> float:
    """The largest ``|x - x on rank 0|`` over every leaf and every rank:
    0.0 when every rank holds the same values (the check that the
    replicated state stays replicated)."""
    if fleet_extent(mesh) == 1:
        return 0.0
    import torch.distributed as dist
    worst = torch.zeros((), dtype=torch.float64,
                        device=mesh.device_type)
    for _, x in tree_flatten_with_path(tree):
        ref = fleet_broadcast({"x": x.clone()}, 0, mesh)["x"]
        if x.numel():
            # a NaN on one side only is infinite drift; on both, none
            d = (x.double() - ref.double()).abs().nan_to_num(nan=np.inf)
            both = torch.isnan(x.double()) & torch.isnan(ref.double())
            worst = torch.maximum(worst, torch.where(
                both, torch.zeros_like(d), d).max())
    return float(_all_reduce(worst.reshape(1), mesh,
                             dist.ReduceOp.MAX)[0])
