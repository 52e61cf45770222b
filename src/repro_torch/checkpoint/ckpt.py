"""Flat-npz checkpointing with a JSON manifest: the reference's format,
so a checkpoint written by either package loads in the other.

A checkpoint is two sibling files: ``<path>.npz`` holding every array
leaf under a ``/``-joined tree path, and ``<path>.json`` recording the
format version, the step, caller metadata, and each leaf's dtype and
shape. Tensors go to host numpy before writing; empty containers flatten
to nothing (callers re-initialize them, e.g. a stateless optimizer's
``()``). ``load_checkpoint`` validates the npz payload against the
manifest, so a truncated or mismatched pair fails loudly instead of
restoring garbage, and returns numpy arrays.

bfloat16 leaves are refused, on write and on read: numpy has no
bfloat16, and raw 16-bit words would read back as integers. No trainable
configuration has bfloat16 leaves yet; they come with the LM training
slice.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def _no_bf16(path: str, key: str) -> ValueError:
    return ValueError(
        f"checkpoint {path!r}: leaf {key!r} is bfloat16, which this format "
        "cannot hold (numpy has no bfloat16); bfloat16 training state "
        "comes with the LM training slice (ROADMAP queue 1, \"The LM "
        "training slice\")")


def _leaf(path: str, key: str, x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise _no_bf16(path, key)
        return x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        raise _no_bf16(path, key)
    return arr


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``/``-joined key -> leaf; dicts in insertion order, lists and
    tuples by index."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def save_checkpoint(path: str, tree: Dict[str, Any], *, step: int = 0,
                    meta: Dict[str, Any] = None) -> None:
    """Write ``tree`` (tensors, numpy arrays or scalars) to
    ``<path>.npz`` and its manifest to ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _leaf(path, k, v) for k, v in _flatten(tree).items()}
    np.savez(path + ".npz", **flat)
    manifest = {"format": FORMAT_VERSION, "step": step, "meta": meta or {},
                "keys": sorted(flat.keys()),
                "dtypes": {k: str(v.dtype) for k, v in flat.items()},
                "shapes": {k: list(v.shape) for k, v in flat.items()}}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (nested dict of numpy arrays, manifest)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    for key in manifest["keys"]:
        if manifest["dtypes"].get(key) == "bfloat16":
            raise _no_bf16(path, key)
    tree: Dict[str, Any] = {}
    with np.load(path + ".npz") as data:
        missing = sorted(set(manifest["keys"]) - set(data.files))
        if missing:
            raise ValueError(f"checkpoint {path!r}: manifest lists "
                             f"{len(missing)} arrays absent from the npz "
                             f"payload, e.g. {missing[:3]}")
        for key in manifest["keys"]:
            arr = data[key]
            want_shape = tuple(manifest["shapes"][key])
            if arr.shape != want_shape:
                raise ValueError(f"checkpoint {path!r}: {key} has shape "
                                 f"{arr.shape}, manifest says {want_shape}")
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree, manifest
