"""Mamba-2 SSD (state-space duality) mixer: the JAX package's
``models/ssm.py`` in PyTorch, cast for cast.

The prefill (``ssm_apply``) runs the chunked SSD scan: with
``cfg.use_pallas`` and no gradient being recorded, through the
hand-written ``ssd_scan`` kernel (``kernels/ssd_scan/ops.py``, which adds
``D·x`` itself); otherwise through the plain ``ssd_chunked`` plus ``D·x``,
the reference's own route. The reference never calls its Pallas kernel
from a model; the port does when it serves (departure (e) in ROADMAP.md).
Training records a gradient, and the kernel has none (nor has the
reference's), so a training forward takes ``ssd_chunked`` under autograd,
as the reference's training does; the rule reads only the grad mode and
the inputs, never the device or a build. The single-token
``ssm_decode_step`` is the plain recurrence on both routes.

Casts follow the reference: the projections, the causal conv, ``silu``
and ``dt = softplus(x·w_dt + dt_bias)`` run in the parameter dtype (bf16
at full width); the scan and ``D`` in fp32; ``y`` goes back to the input
dtype before the gate's ``rmsnorm``.

The ``ssm_moe`` family (Granite-4.0-H) runs the published Mamba-2 mixer
instead (``granite_params``, ``granite_mix``): one input projection to
(z, x, B, C, dt), the causal conv over x, B and C together, and the gate
applied to y before the gated RMS norm, in fp32 from the scan to the
norm, as the source computes it. Its scan is ``ssd_chunks_at_once``, the
chunked scan with every chunk at once (the same terms in a fixed number
of operations: the chunk loop's launches pace the card at 4,096 rows).
The form above (the conv over x alone, the norm before the gate, the
chunk loop) stays the Mamba2 and Hymba families', which are held to the
JAX package.

Both mixers are the ``repro_torch.trace`` span ``ssm.mix``, and their
scan with its ``D·x`` skip (the kernel, or a plain scan and the skip)
the span ``ssm.scan`` inside it, in every forward run, remat's
recomputations included. Their backward passes are bounded by the
points ``ssm.mix.backward.begin`` and ``.end`` (``ssm.scan.backward.*``
likewise): the output's gradient reached, and every input's and
parameter's gradient computed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as SS
from repro_torch.kernels.ssd_scan.ref import (DEFAULT_CHUNK, ssd_chunked,
                                              ssd_chunks_at_once)
from repro_torch.models import layers as L
from repro_torch.trace import backward_point, span


def ssm_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    dm = cfg.d_model
    din = cfg.ssm_d_inner
    nh = cfg.ssm_n_heads
    st = cfg.ssm_state
    k = cfg.ssm_conv_dim
    return {
        "w_x": L.dense_init(gen, dm, din, dtype),
        "w_z": L.dense_init(gen, dm, din, dtype),
        "w_B": L.dense_init(gen, dm, st, dtype),
        "w_C": L.dense_init(gen, dm, st, dtype),
        "w_dt": L.dense_init(gen, dm, nh, dtype),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01))).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh)).to(dtype),
        "D": L.ones((nh,), dtype),
        "conv_w": L.normal(gen, (k, din), dtype, scale=0.1),
        "conv_b": L.zeros((din,), dtype),
        "gate_norm_scale": L.zeros((din,), dtype),
        "w_out": L.dense_init(gen, din, dm, dtype),
    }


def _softplus(x):
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``, op for op as
    ``lax`` writes it: max(x, 0) + log1p(e^−|x|), each op rounded in x's
    dtype (``F.softplus`` turns into the identity above its threshold of
    20, and ``torch.logaddexp`` rounds once, one bf16 ulp off in a fifth
    of the outputs)."""
    return torch.relu(x) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(x, w, b):
    """Depthwise causal conv. x [B,S,D]; w [k,D]: a sum of k products in
    the input dtype, from 0, in the order i = 0..k-1."""
    k = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(k))
    return out + b


def ssm_apply(cfg: ModelConfig, p, x_in, *, chunk: int = DEFAULT_CHUNK,
              return_state: bool = False):
    """Full Mamba2 mixer on [B,S,dm] -> [B,S,dm] (the prefill path); with
    ``return_state`` also the final state h [B,nh,hd,st] (fp32) and the
    conv tail [B,k-1,d_inner] for the cache."""
    with span("ssm.mix"):
        x_in, *leaves = backward_point("ssm.mix.backward.end", x_in,
                                       *p.values())
        p = dict(zip(p, leaves))
        y, z, h_final, xs_raw = ssm_mix(cfg, p, x_in, chunk=chunk)
        out = backward_point("ssm.mix.backward.begin", ssm_out(p, y, z))
    if return_state:
        return out, h_final, conv_tail(cfg, xs_raw)
    return out


def conv_tail(cfg: ModelConfig, xs_raw):
    """The last k-1 pre-conv inputs [B,k-1,d_inner]: the decode cache's
    conv window."""
    return xs_raw[:, xs_raw.shape[1] - (cfg.ssm_conv_dim - 1):, :]


def ssm_mix(cfg: ModelConfig, p, x_in, *, chunk: int = DEFAULT_CHUNK,
            n_heads: int = None):
    """The mixer up to its gated norm: (y [B,S,nh·hd] in the input dtype,
    the gate z, the final state h [B,nh,hd,st] fp32, the pre-conv input
    [B,S,d_inner]). ``n_heads`` (default: the config's) is the heads of
    ``p``: a tensor-parallel rank's slice of them, with ``w_x``, ``w_z``,
    ``conv_*``, ``w_dt``, ``dt_bias``, ``A_log`` and ``D`` cut to it."""
    nh = cfg.ssm_n_heads if n_heads is None else n_heads
    hd = cfg.ssm_head_dim
    xs_raw = x_in @ p["w_x"]
    z = x_in @ p["w_z"]
    xs = L.silu(causal_conv(xs_raw, p["conv_w"], p["conv_b"]))
    B = x_in @ p["w_B"]
    C = x_in @ p["w_C"]
    dt = _softplus((x_in @ p["w_dt"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    Bsz, S = x_in.shape[:2]
    xh = xs.reshape(Bsz, S, nh, hd)
    scan_in = (xh.float(), dt.float(), A, B.float(), C.float(),
               p["D"].float())
    recording = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in scan_in)
    with span("ssm.scan"):
        if cfg.use_pallas and not recording:
            y, h_final = SS.ssd_scan(*scan_in)
        else:
            scan_in = backward_point("ssm.scan.backward.end", *scan_in)
            y, h_final = ssd_chunked(*scan_in[:5], chunk=chunk)
            y = y + scan_in[0] * scan_in[5][None, None, :, None]
            y = backward_point("ssm.scan.backward.begin", y)
    return y.reshape(Bsz, S, nh * hd).to(x_in.dtype), z, h_final, xs_raw


def granite_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    """The published mixer's leaves: ``w_in`` [dm, 2·d_inner + 2·state +
    nh] (z, x, B, C, dt in that order, one group), ``conv_w`` [k, d_inner
    + 2·state] and ``conv_b``, ``dt_bias`` (dt 0.01), ``A_log`` (A = 1 ..
    nh), ``D``, ``gate_norm_scale`` (scale − 1) and ``w_out``."""
    dm, din = cfg.d_model, cfg.ssm_d_inner
    nh, st, k = cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_conv_dim
    return {
        "w_in": L.dense_init(gen, dm, 2 * din + 2 * st + nh, dtype),
        "conv_w": L.normal(gen, (k, din + 2 * st), dtype, scale=0.1),
        "conv_b": L.zeros((din + 2 * st,), dtype),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01))).to(dtype),
        "A_log": torch.log(torch.arange(1, nh + 1,
                                        dtype=torch.float32)).to(dtype),
        "D": L.ones((nh,), dtype),
        "gate_norm_scale": L.zeros((din,), dtype),
        "w_out": L.dense_init(gen, din, dm, dtype,
                              scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def granite_mix(cfg: ModelConfig, p, x_in, *, chunk: int = DEFAULT_CHUNK):
    """The published Mamba-2 mixer on [B,S,dm] -> [B,S,dm]: the projection
    and the conv in the parameter dtype, ``dt = softplus(dt + dt_bias)``,
    the scan (every chunk at once), ``D·x``, the gate ``silu(z)`` and the
    gated RMS norm (eps ``cfg.rms_norm_eps``, over the whole d_inner) in
    fp32, then ``w_out``."""
    din, st = cfg.ssm_d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_n_heads, cfg.ssm_head_dim
    with span("ssm.mix"):
        x_in, *leaves = backward_point("ssm.mix.backward.end", x_in,
                                       *p.values())
        p = dict(zip(p, leaves))
        z, xbc, dt = (x_in @ p["w_in"]).split([din, din + 2 * st, nh], -1)
        xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
        xs, B, C = xbc.split([din, st, st], -1)
        dt = F.softplus((dt + p["dt_bias"]).float())
        A = -torch.exp(p["A_log"].float())
        Bsz, S = x_in.shape[:2]
        xh = xs.reshape(Bsz, S, nh, hd).float()
        with span("ssm.scan"):
            xh, dt, A, B, C, D = backward_point(
                "ssm.scan.backward.end", xh, dt, A, B.float(), C.float(),
                p["D"].float())
            y, _ = ssd_chunks_at_once(xh, dt, A, B, C, chunk=chunk)
            y = backward_point("ssm.scan.backward.begin",
                               y + xh * D[None, None, :, None])
        g = y.reshape(Bsz, S, din) * F.silu(z.float())
        y = L.rmsnorm(g, p["gate_norm_scale"], cfg.rms_norm_eps)
        return backward_point("ssm.mix.backward.begin",
                              y.to(x_in.dtype) @ p["w_out"])


def ssm_out(p, y, z, var=None):
    """The mixer after ``ssm_mix``: the gated ``rmsnorm`` of y, then
    ``w_out`` (``var``: the mean square of y over the whole d_inner, for a
    rank that holds a slice of it)."""
    y = L.rmsnorm(y, p["gate_norm_scale"], var=var) * L.silu(z)
    return y @ p["w_out"]


def ssm_decode_init(cfg: ModelConfig, batch: int, dtype, device):
    return {
        "h": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, cfg.ssm_d_inner),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p, x_in, state):
    """x_in [B,1,dm]; state as ``ssm_decode_init`` makes it. Returns
    (y [B,1,dm], the new state); ``state`` is not written."""
    y, z, new = ssm_decode_mix(cfg, p, x_in, state)
    return ssm_out(p, y, z)[:, None, :], new


def ssm_decode_mix(cfg: ModelConfig, p, x_in, state, n_heads: int = None):
    """``ssm_decode_step`` up to its gated norm: (y [B,nh·hd], the gate z
    [B,d_inner], the new state); ``n_heads`` as in ``ssm_mix``."""
    nh = cfg.ssm_n_heads if n_heads is None else n_heads
    hd = cfg.ssm_head_dim
    x = x_in[:, 0, :]
    xs = x @ p["w_x"]                                # [B,din]
    z = x @ p["w_z"]
    window = torch.cat([state["conv"], xs[:, None, :]], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xs = L.silu(conv_out)
    new_conv = window[:, 1:, :]
    B = (x @ p["w_B"]).float()                       # [B,st]
    C = (x @ p["w_C"]).float()
    dt = _softplus((x @ p["w_dt"]) + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(-1, nh, hd).float()
    a = torch.exp(dt * A)                            # [B,nh]
    h = state["h"] * a[:, :, None, None] + torch.einsum(
        "bh,bhd,bs->bhds", dt, xh, B)
    y = torch.einsum("bs,bhds->bhd", C, h) + \
        xh * p["D"].float()[None, :, None]
    y = y.reshape(x.shape[0], nh * hd).to(x_in.dtype)
    return y, z, {"h": h, "conv": new_conv}
