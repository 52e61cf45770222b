"""Weights of an ``reference.ssm_moe_shapes`` tree drawn from a seed on
the device, as ``traffic/weights.py`` draws a tree (one call per leaf,
from one ``torch.Generator`` on the device, then cast to the configured
dtype), with Mamba-2's own initialisations for two leaves: A = U[1, 16]
(``A_log`` holds log A) and dt = exp(U[ln 0.001, ln 0.1]) floored at
1e-4 (``dt_bias`` holds softplus⁻¹(dt)), so the scan carries its state
across chunks. Replaying ``iter_leaves`` with the same seed gives the
same tensors leaf by leaf."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from reference.shapes import leaves


def iter_leaves(tree: Dict, *, seed: int, dtype: torch.dtype, device
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, leaf in leaves(tree):
        if leaf.init == "normal":
            x = torch.randn(leaf.shape, generator=gen, device=device)
            x = x.mul_(leaf.scale)
        elif leaf.init == "A_log":
            x = torch.rand(leaf.shape, generator=gen, device=device)
            x = x.mul_(15.0).add_(1.0).log_()
        elif leaf.init == "dt_bias":
            u = torch.rand(leaf.shape, generator=gen, device=device)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = u.mul_(hi - lo).add_(lo).exp_().clamp_(min=1e-4)
            x = dt + torch.log(-torch.expm1(-dt))
        elif leaf.init == "zeros":
            x = torch.zeros(leaf.shape, device=device)
        else:
            x = torch.ones(leaf.shape, device=device)
        yield path, x.to(dtype)


def draw(tree: Dict, *, seed: int, dtype: torch.dtype, device) -> Dict:
    """The whole tree, as nested dicts of tensors."""
    out: Dict = {}
    for path, x in iter_leaves(tree, seed=seed, dtype=dtype, device=device):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out
