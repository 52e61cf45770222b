"""Weights drawn from a seed on the device: one ``torch.randn`` per leaf
of a ``reference.shapes`` tree (a stacked layer leaf in one call), from
one ``torch.Generator`` on the device, scaled and cast to the served
dtype. Replaying ``iter_leaves`` with the same seed gives the same
tensors leaf by leaf, so a check can redraw a leaf instead of keeping a
copy of it."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from reference.shapes import leaves


def iter_leaves(tree: Dict, *, seed: int, dtype: torch.dtype, device
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, leaf in leaves(tree):
        if leaf.init == "normal":
            x = torch.randn(leaf.shape, generator=gen, device=device)
            x = x.mul_(leaf.scale).to(dtype)
        elif leaf.init == "zeros":
            x = torch.zeros(leaf.shape, dtype=dtype, device=device)
        else:
            x = torch.ones(leaf.shape, dtype=dtype, device=device)
        yield path, x


def draw(tree: Dict, *, seed: int, dtype: torch.dtype, device) -> Dict:
    """The whole tree, as nested dicts of tensors."""
    out: Dict = {}
    for path, x in iter_leaves(tree, seed=seed, dtype=dtype, device=device):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out
