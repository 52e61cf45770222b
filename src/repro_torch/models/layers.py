"""Shared neural-net building blocks, the ViT subset of the JAX package's
``models/layers.py``: plain functions over dicts of tensors whose keys are
the reference's. Per-layer trees stack along a leading ``L`` axis; that
stacked tree is the weight-sharing super-network.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float = 0.02):
    """N(0, scale²) weights drawn from ``gen`` (on the CPU: a generator's
    draws are device-specific, so the port draws once and moves)."""
    return (torch.randn((in_dim, out_dim), generator=gen) * scale).to(dtype)


def zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


def ones(shape, dtype):
    return torch.ones(shape, dtype=dtype)


# --------------------------------------------------------------------- norms

def layernorm(x, scale, bias, eps: float = 1e-5):
    """fp32 layer norm with the population variance, as the reference."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, x, p, prefix: str):
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])
    raise NotImplementedError(
        f"norm={cfg.norm!r}: the port has layernorm only so far "
        "(ROADMAP queue 1, item 6: the rest of the model zoo)")


def norm_params(cfg: ModelConfig, dm: int, dtype):
    if cfg.norm == "layernorm":
        return {"scale": ones((dm,), dtype), "bias": zeros((dm,), dtype)}
    raise NotImplementedError(
        f"norm={cfg.norm!r}: ROADMAP queue 1, item 6")


# ----------------------------------------------------------------- attention

def attention(q, k, v, *, mask=None):
    """Reference attention with GQA broadcast, fp32 scores.

    q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] with H % K == 0.
    mask: broadcastable to [B, H, Sq, Sk] (True = attend).
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k).float() / math.sqrt(hd)
    scores = scores.reshape(B, H, Sq, k.shape[1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.reshape(B, K, G, Sq, k.shape[1])
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def make_attn_mask(pos_q, pos_k, *, causal: bool, window: int = 0):
    """[B, 1, Sq, Sk] boolean mask from absolute positions."""
    dq = pos_q[:, :, None]
    dk = pos_k[:, None, :]
    m = torch.ones(dq.shape[:2] + (pos_k.shape[-1],), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m = m & (dk <= dq)
    if window and window > 0:
        m = m & (dk > dq - window)
    return m[:, None, :, :]


def attn_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    hd = cfg.resolved_head_dim
    H, K, dm = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": dense_init(gen, dm, H * hd, dtype),
        "wk": dense_init(gen, dm, K * hd, dtype),
        "wv": dense_init(gen, dm, K * hd, dtype),
        "wo": dense_init(gen, H * hd, dm, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H * hd,), dtype)
        p["bk"] = zeros((K * hd,), dtype)
        p["bv"] = zeros((K * hd,), dtype)
    return p


def project_qkv(cfg: ModelConfig, p, xq, xkv):
    """Returns q [B,Sq,H,hd], k,v [B,Skv,K,hd]."""
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    return (q.reshape(B, Sq, H, hd), k.reshape(B, Skv, K, hd),
            v.reshape(B, Skv, K, hd))


# ----------------------------------------------------------------------- mlp

def mlp_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    if cfg.mlp != "gelu":
        raise NotImplementedError(
            f"mlp={cfg.mlp!r}: the port has the gelu MLP only so far "
            "(ROADMAP queue 1, item 6)")
    dm, dff = cfg.d_model, cfg.d_ff
    down_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "w_up": dense_init(gen, dm, dff, dtype),
        "b_up": zeros((dff,), dtype),
        "w_down": dense_init(gen, dff, dm, dtype, scale=down_scale),
        "b_down": zeros((dm,), dtype),
    }


def mlp_apply(cfg: ModelConfig, p, x):
    if cfg.mlp != "gelu":
        raise NotImplementedError(f"mlp={cfg.mlp!r}: ROADMAP queue 1, item 6")
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# -------------------------------------------------------------------- losses

def softmax_xent(logits, labels):
    """Mean cross-entropy in fp32. logits [..., V]; labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
