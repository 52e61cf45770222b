"""Plain PyTorch versions of the TPGF fusion kernels.

``fuse`` (paper Eq. 4):

    out = w_client * (g_client * clip_scale) + (1 - w_client) * g_server

in fp32, cast back to ``g_client``'s dtype. ``clip_scale`` is the
global-L2 clip factor min(1, tau/||g||), 1.0 on the engine's path.

``tier_sum``: ``sum_t w[t] * x[t]`` in fp32, accumulated in tier order
(``acc = w0*x0``, then ``acc + w_t*x_t``), the order of
``core.tpgf.fuse_tiers``' plain path. ``sumsq``: ``sum x^2`` in fp32.

``plain_chain_bound``: how far TPGF's Phase 3 on the card (``sumsq`` and
``fuse``, one rounding) may lie from the plain chain, which rounds the
clipped gradient to bf16 before Eq. 4 and then rounds again.
"""
from __future__ import annotations

import torch


def fuse(g_client, g_server, w_client, clip_scale):
    a = g_client.float()
    b = g_server.float()
    out = w_client * (a * clip_scale) + (1.0 - w_client) * b
    return out.to(g_client.dtype)


def tier_sum(leaves, weights):
    acc = None
    for w, x in zip(weights, leaves):
        term = w * x.float()
        acc = term if acc is None else acc + term
    return acc


def sumsq(x):
    return torch.sum(torch.square(x.float()))


def eq4_fp32(g_client, g_server, w_client, clip_scale):
    """Eq. 4 with the clip scale inside, in fp32, not rounded."""
    w = w_client.float()
    return w * (g_client.float() * clip_scale) + (1.0 - w) * g_server.float()


def bf16_ulp(x):
    """The spacing of bf16 values at ``|x|`` (at 0, the smallest normal's),
    in fp32."""
    m, e = torch.frexp(x.float().abs())
    e = torch.where(m == 0, torch.full_like(e, -125), e)
    return torch.ldexp(torch.ones_like(m), e - 8)


def plain_chain_bound(fused, plain, g_client, w_client, clip_scale):
    """Elementwise, how far ``fused`` (Eq. 4 with the clip scale inside,
    rounded once) may lie from ``plain`` (the clipped gradient rounded to
    bf16, then Eq. 4 rounded again): one ulp of the result plus ``w``
    times one ulp of the clipped term. Where Eq. 4's two terms cancel,
    the second part is many ulps of the small result, so one ulp of the
    result is no bound."""
    return torch.maximum(bf16_ulp(fused), bf16_ulp(plain)) \
        + w_client.float() * bf16_ulp(g_client.float() * clip_scale)
