"""Plain PyTorch version of the TPGF fusion kernel (paper Eq. 4).

    out = w_client * (g_client * clip_scale) + (1 - w_client) * g_server

in fp32, cast back to ``g_client``'s dtype. ``clip_scale`` is the
global-L2 clip factor min(1, tau/||g||), 1.0 on the engine's path.
"""
from __future__ import annotations


def fuse(g_client, g_server, w_client, clip_scale):
    a = g_client.float()
    b = g_server.float()
    out = w_client * (a * clip_scale) + (1.0 - w_client) * b
    return out.to(g_client.dtype)
