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

bfloat16 leaves are written as the reference writes them: numpy has no
bfloat16, so the npz holds each one's raw 2-byte words (dtype ``|V2``)
and the manifest names its dtype ``"bfloat16"``. ``load_checkpoint``
returns such a leaf as a CPU ``torch.bfloat16`` tensor with the same
bits (no numpy type holds them losslessly); every other leaf comes back
as a numpy array.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
_BF16 = "bfloat16"
_RAW16 = np.dtype("V2")          # how np.savez stores a bfloat16 array


def _leaf(x) -> Tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_RAW16), _BF16
        arr = x.numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == _BF16:
            return arr.view(np.uint16).view(_RAW16), _BF16
    return arr, str(arr.dtype)


def _bf16_tensor(path: str, key: str, arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.itemsize != 2:
        raise ValueError(f"checkpoint {path!r}: {key} is bfloat16 in the "
                         f"manifest but {arr.dtype} in the npz payload")
    words = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(words.copy()).view(torch.bfloat16)


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
    leaves = {k: _leaf(v) for k, v in _flatten(tree).items()}
    flat = {k: arr for k, (arr, _) in leaves.items()}
    np.savez(path + ".npz", **flat)
    manifest = {"format": FORMAT_VERSION, "step": step, "meta": meta or {},
                "keys": sorted(flat.keys()),
                "dtypes": {k: name for k, (_, name) in leaves.items()},
                "shapes": {k: list(v.shape) for k, v in flat.items()}}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (nested dict of numpy arrays, bfloat16 leaves as CPU
    ``torch.bfloat16`` tensors; the manifest)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
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
            if manifest["dtypes"].get(key) == _BF16:
                arr = _bf16_tensor(path, key, arr)
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree, manifest
