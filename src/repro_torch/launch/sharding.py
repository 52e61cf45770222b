"""Sharding for the port's two kinds of mesh.

**The LM section** (the counterpart of the JAX package's
``launch/sharding.py`` rules): which dims of the parameters, the optimizer
moments, the batch and the decode cache shard over which axes of a
``("data", "model")`` (or ``("pod", "data", "model")``) mesh, and the
DTensor placements that say so.

  - FSDP over ``("pod", "data")``: the d_model ("input feature") dim of
    the big projections and the embedding's feature dim.
  - Tensor parallel over ``"model"``: vocab, the flattened head dim
    (H·hd), d_ff, the SSM's d_inner. Every rule is checked for
    divisibility against the dim and falls back to replication, so no
    shard is ever uneven.
  - The batch over ``("pod", "data")`` wherever it divides.

``param_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` return the
reference's specs, leaf for leaf, as :class:`P` tuples of per-dimension
axis names; :func:`placements` turns one into DTensor placements and
:func:`distribute_tree` places a tree by them. Nothing here runs a
collective by hand: what the sharded LM steps communicate is DTensor's
redistributions (``models/sharded.py``).

**The fleet section**: the fleet (client) axis over a
``launch.mesh.make_fleet_mesh`` mesh: which rank owns which client, and
the few collectives the engine's strategies need.

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
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import TENSOR_AXIS, axis_names, axis_sizes, \
    fsdp_axes
from repro_torch.tree import (tree_flatten_with_path, tree_get, tree_map,
                              tree_rebuild, tree_unflatten)

_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMED = {"on": False}


# ================================================================ LM section

class P(tuple):
    """A PartitionSpec: one entry a tensor dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (the dim shards
    over their product, the first the major one)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _fit(mesh, dim: int, axes):
    """``axes`` if the dim divides the mesh extent, else None."""
    if axes is None or dim is None:
        return None
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def _spec_for(mesh, name: str, parent: str, shape, fsdp) -> P:
    nd = len(shape)
    t = TENSOR_AXIS

    def mk(*ax):
        # divisibility-check every proposed axis
        return P(*[None if a is None else _fit(mesh, shape[i], a)
                   for i, a in enumerate(ax)])

    stacked = nd >= 1 and parent in ("layers", "enc_layers", "dec_layers")
    lead = [None] * (1 if stacked else 0)

    if name == "embed":
        return mk(t, fsdp)
    if name in ("unembed", "local_head", "frame_proj", "vision_proj"):
        return mk(fsdp, t)
    if name in ("wq", "wk", "wv"):
        return mk(*lead, fsdp, t)
    if name == "wo":
        return mk(*lead, t, fsdp)
    if name in ("bq", "bk", "bv", "b_up"):
        return mk(*lead, t)
    if name in ("w_gate", "w_up"):
        if nd - len(lead) == 3:                # MoE expert weights [E,dm,dff]
            return mk(*lead, None, fsdp, t)
        return mk(*lead, fsdp, t)
    if name == "w_down":
        if nd - len(lead) == 3:
            return mk(*lead, None, t, fsdp)
        return mk(*lead, t, fsdp)
    if name == "router":
        return mk(*lead, fsdp, None)
    if name in ("w_x", "w_z"):
        return mk(*lead, fsdp, t)
    if name in ("w_B", "w_C", "w_dt"):
        return mk(*lead, fsdp, None)
    if name == "w_out":
        return mk(*lead, t, fsdp)
    if name == "conv_w":
        return mk(*lead, None, t)
    if name in ("conv_b", "gate_norm_scale"):
        return mk(*lead, t)
    return P()  # norms, scalars, positional tables, vit bits: replicate


def param_pspecs(cfg, params_shapes, mesh) -> Dict[str, Any]:
    """The spec tree of a params (shape) tree: anything with ``.shape``
    at the leaves (``launch.steps.params_specs``'s meta tensors)."""
    if cfg.family == "ssm_moe":
        raise NotImplementedError("family='ssm_moe' on a mesh: not ported")
    fsdp = fsdp_axes(mesh)
    flat = tree_flatten_with_path(params_shapes)
    return tree_unflatten(
        [p for p, _ in flat],
        [_spec_for(mesh, p[-1], p[0], tuple(x.shape), fsdp)
         for p, x in flat])


def batch_pspecs(cfg, shape, batch_shapes, mesh) -> Dict[str, Any]:
    """Each batch leaf's leading (batch) dim over the data axes where it
    divides; a 0-d leaf replicated."""
    dp = fsdp_axes(mesh)

    def spec(leaf):
        if not len(leaf.shape):
            return P()
        return P(_fit(mesh, leaf.shape[0], dp), *([None] * (len(leaf.shape)
                                                            - 1)))

    return {k: spec(v) for k, v in batch_shapes.items()}


def cache_pspecs(cfg, cache_shapes, mesh) -> Dict[str, Any]:
    """The decode cache's specs: the batch over the data axes where it
    divides, else (batch 1, "heads") the window over ``"data"``; kv heads
    (else head_dim) over ``"model"``, or with ``decode_cache_shard="seq"``
    the window over ``"model"``; SSM heads (else head_dim) and the conv's
    d_inner over ``"model"``."""
    dp = fsdp_axes(mesh)
    t = TENSOR_AXIS
    out: Dict[str, Any] = {}
    for k, v in cache_shapes.items():
        if k == "idx":
            out[k] = P()
        elif k == "pos":
            B, W = v.shape
            bax = _fit(mesh, B, dp)
            if cfg.decode_cache_shard == "seq":
                out[k] = P(bax, _fit(mesh, W, t))
            else:
                wax = None if bax else _fit(mesh, W, ("data",))
                out[k] = P(bax, wax)
        elif k in ("k", "v", "cross_k", "cross_v"):
            L_, B, W, K, hd = v.shape
            bax = _fit(mesh, B, dp)
            if cfg.decode_cache_shard == "seq":
                out[k] = P(None, bax, _fit(mesh, W, t), None, None)
            else:
                wax = None if bax else _fit(mesh, W, ("data",))
                kax = _fit(mesh, K, t)
                hax = None if kax else _fit(mesh, hd, t)
                out[k] = P(None, bax, wax, kax, hax)
        elif k == "ssm_h":
            L_, B, nh, hd, st = v.shape
            bax = _fit(mesh, B, dp)
            nax = _fit(mesh, nh, t)
            hax = None if nax else _fit(mesh, hd, t)
            out[k] = P(None, bax, nax, hax, None)
        elif k == "ssm_conv":
            L_, B, kk, din = v.shape
            out[k] = P(None, _fit(mesh, B, dp), None, _fit(mesh, din, t))
        else:
            out[k] = P()
    return out


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    mesh order, ``Shard(i)`` where tensor dim ``i`` names its axis, else
    ``Replicate()`` (a dim over ``("pod", "data")`` takes ``Shard(i)`` on
    both). A mesh dim of size 1 holds the whole tensor either way: it
    gets ``Replicate()``, so that no redistribution runs over it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for m, name in enumerate(axis_names(mesh)):
        dims = [i for i, e in enumerate(spec) if name in _names(e)]
        out.append(Shard(dims[0]) if dims and mesh.size(m) > 1
                   else Replicate())
    return tuple(out)


def local_shape(shape, mesh, pls) -> Tuple[int, ...]:
    """The shape of this rank's shard of a ``shape`` tensor placed by
    ``pls`` (every shard even, as the spec rules make them)."""
    shape = list(shape)
    for m, pl in enumerate(pls):
        if pl.is_shard():
            shape[pl.dim] //= mesh.size(m)
    return tuple(shape)


def local_slice(x: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` placed by ``pls``: a
    view, chunked over the mesh dims in order."""
    coord = mesh.get_coordinate()
    for m, pl in enumerate(pls):
        if pl.is_shard():
            n = x.shape[pl.dim] // mesh.size(m)
            x = x.narrow(pl.dim, coord[m] * n, n)
    return x


def as_dtensor(local: torch.Tensor, mesh, pls, shape):
    """The DTensor whose shard on this rank is ``local`` (no
    communication), of global ``shape``."""
    from torch.distributed.tensor import DTensor
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def place(x: torch.Tensor, spec, mesh):
    """The whole tensor ``x`` (the same on every rank) as a DTensor placed
    by ``spec``, from this rank's slice alone (no communication). A
    ``meta`` tensor gives an uninitialised shard on the mesh's device
    type (a fake one under ``FakeTensorMode``)."""
    pls = placements(spec, mesh)
    if x.is_meta:
        local = torch.empty(local_shape(x.shape, mesh, pls), dtype=x.dtype,
                            device=mesh.device_type)
    else:
        _check_backend(x, mesh)
        local = local_slice(x, mesh, pls).clone()
    return as_dtensor(local, mesh, pls, tuple(x.shape))


def _check_backend(x: torch.Tensor, mesh) -> None:
    """A CUDA tensor on a gloo mesh raises: gloo runs only all_reduce and
    broadcast on CUDA tensors."""
    import torch.distributed as dist
    if x.is_cuda and dist.get_backend(mesh.get_group(0)) == "gloo":
        raise ValueError(
            "a CUDA tensor on a gloo mesh: gloo runs only all_reduce and "
            "broadcast on CUDA tensors, and DTensor's redistributions need "
            "all_gather and reduce_scatter too; use an NCCL mesh")


def distribute_tree(tree, specs, mesh):
    """Every tensor leaf of ``tree`` placed by its spec in ``specs`` (a
    tree of :class:`P` of the same structure) with :func:`place`; other
    leaves (the cache's host ``idx``) as they are."""
    out = {}
    for path, x in tree_flatten_with_path(tree):
        if isinstance(x, torch.Tensor):
            x = place(x, tree_get(specs, path), mesh)
        out[path] = x
    return tree_rebuild(tree, out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree``, else None."""
    for _, x in tree_flatten_with_path(tree):
        if is_dtensor(x):
            return x.device_mesh
    return None


def match_placements(grads, params):
    """Each DTensor gradient redistributed to its parameter's placements
    (a reduce-scatter or all-reduce of the partial sums the data ranks
    left); plain leaves as they are."""
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if is_dtensor(g) and g.placements != p.placements
                    else g, grads, params)


def gather_tree(tree):
    """Every DTensor leaf as the whole tensor on every rank
    (``full_tensor``); plain leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


# =============================================================== fleet section

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
