"""Numpy <-> torch trees, and carrying weights into a port engine.

The JAX package initialises its weights from ``jax.random``, whose bits
torch cannot reproduce; the port's ``init_params`` draws the same shapes
and distributions from a ``torch.Generator``. To compute from the SAME
weights on both sides, a caller turns the reference's trees into numpy
arrays (on its side) and hands them to ``install_weights`` (an engine)
or ``to_model_params`` (a bare model). Only weights
cross: the data, fleet, availability and batch-index streams are seeded
numpy on both sides and already agree.

bfloat16 numpy arrays (the ``ml_dtypes`` type) cross as float32 values,
which is exact; ``to_numpy`` returns bfloat16 tensors as float32 too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, torch_dtype
from repro_torch.tree import tree_flatten_with_path, tree_map


def _leaf_to_torch(x, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    # always a copy: the engine updates some trees in place, and must never
    # write through into the caller's arrays
    t = torch.tensor(arr)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def to_torch(tree, device=None):
    """A numpy tree -> the same tree of tensors on ``device`` (None: the
    card, see ``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, device), tree)


def to_numpy(tree):
    """A tensor tree -> the same tree of numpy arrays (bf16 as float32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)


def _check_like(name: str, ref, new) -> None:
    want = {p: tuple(x.shape) for p, x in tree_flatten_with_path(ref)}
    got = {p: tuple(np.shape(x)) for p, x in tree_flatten_with_path(new)}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shapes = sorted(p for p in set(want) & set(got) if want[p] != got[p])
        raise ValueError(f"{name} does not match the "
                         f"port's tree (missing {missing}, extra {extra}, "
                         f"shape mismatches {shapes})")


def to_model_params(cfg, params: Dict[str, Any], device=None,
                    dtype: torch.dtype = None, *, mesh=None) -> Dict[str, Any]:
    """A reference model-params tree as numpy arrays -> the port's model
    params on ``device`` (None: the card, see
    ``repro_torch.device.resolve_device``), in ``dtype`` (default: the
    config's). The tree
    must have exactly the keys and shapes of the port's ``init_params``
    for ``cfg``; every leaf is copied. The counterpart of
    ``install_weights`` for a bare model, not an ``Engine``. With
    ``mesh`` (an LM mesh) each rank keeps its shards, placed by
    ``launch.sharding.param_pspecs`` as ``init_params(..., mesh=)``
    places them."""
    device = resolve_device(device)
    like = init_params(cfg, None, device="meta")
    _check_like("params", like, params)
    dtype = dtype or torch_dtype(cfg)
    out = tree_map(lambda x: _leaf_to_torch(x, device, dtype), params)
    if mesh is None:
        return out
    from repro_torch.launch import sharding as SH
    return SH.distribute_tree(out, SH.param_pspecs(cfg, like, mesh), mesh)


def install_weights(target, params: Dict[str, Any],
                    local_heads: Dict[str, Any]) -> None:
    """Install numpy ``params`` and stacked ``local_heads`` (the reference
    ``TrainState``'s trees as numpy arrays) into a port ``Engine`` or
    ``TrainState``, on its device and in its dtypes. The trees must have
    exactly the port's keys and shapes. On a fleet mesh each rank calls
    it with every client's heads and keeps the rows it owns."""
    state = getattr(target, "state", target)
    lo, hi = state.rows
    if (lo, hi) != (0, state.n_clients):
        local_heads = tree_map(lambda x: np.asarray(x)[lo:hi], local_heads)
    _check_like("params", state.params, params)
    _check_like("local_heads", state.local_heads, local_heads)
    state.params = tree_map(
        lambda ref, x: _leaf_to_torch(x, ref.device, ref.dtype),
        state.params, params)
    state.local_heads = tree_map(
        lambda ref, x: _leaf_to_torch(x, ref.device, ref.dtype),
        state.local_heads, local_heads)
