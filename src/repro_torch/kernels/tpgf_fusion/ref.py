"""Plain PyTorch versions of the TPGF fusion kernels.

``fuse`` (paper Eq. 4):

    out = w_client * (g_client * clip_scale) + (1 - w_client) * g_server

in fp32, cast back to ``g_client``'s dtype. ``clip_scale`` is the
global-L2 clip factor min(1, tau/||g||), 1.0 on the engine's path.

``tier_sum``: ``sum_t w[t] * x[t]`` in fp32, accumulated in tier order
(``acc = w0*x0``, then ``acc + w_t*x_t``), the order of
``core.tpgf.fuse_tiers``' plain path. ``sumsq``: ``sum x^2`` in fp32.
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
