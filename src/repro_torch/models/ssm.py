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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as SS
from repro_torch.kernels.ssd_scan.ref import DEFAULT_CHUNK, ssd_chunked
from repro_torch.models import layers as L


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
    y, z, h_final, xs_raw = ssm_mix(cfg, p, x_in, chunk=chunk)
    out = ssm_out(p, y, z)
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
    if cfg.use_pallas and not recording:
        y, h_final = SS.ssd_scan(*scan_in)
    else:
        y, h_final = ssd_chunked(*scan_in[:5], chunk=chunk)
        y = y + xh.float() * p["D"].float()[None, None, :, None]
    return y.reshape(Bsz, S, nh * hd).to(x_in.dtype), z, h_final, xs_raw


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
