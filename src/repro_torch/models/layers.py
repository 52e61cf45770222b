"""Shared neural-net building blocks, the ViT and dense-LM subset of the
JAX package's ``models/layers.py``: plain functions over dicts of tensors
whose keys are the reference's. Per-layer trees stack along a leading
``L`` axis; that stacked tree is the weight-sharing super-network.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------- init utils

def normal(gen: torch.Generator, shape, dtype, scale: float = 0.02):
    """N(0, scale²) values drawn from ``gen`` on the generator's own device
    (a generator's draws are device-specific: a CPU generator gives the
    same values on every machine). ``gen=None`` makes a ``meta`` tensor,
    shapes and dtypes only."""
    device = gen.device if gen is not None else torch.device("meta")
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float = 0.02):
    return normal(gen, (in_dim, out_dim), dtype, scale)


def zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


def ones(shape, dtype):
    return torch.ones(shape, dtype=dtype)


# --------------------------------------------------------------------- norms

def rmsnorm(x, scale, eps: float = 1e-6, var=None):
    """fp32 RMS norm; ``scale`` stores (scale - 1), as the reference.
    ``var`` (fp32, [..., 1]) is the mean square when the caller has it:
    a tensor-parallel rank holds a slice of the normed dim and gets the
    mean from every rank's sum of squares."""
    x32 = x.float()
    if var is None:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


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
    return rmsnorm(x, p[f"{prefix}_scale"])


def norm_params(cfg: ModelConfig, dm: int, dtype):
    if cfg.norm == "layernorm":
        return {"scale": ones((dm,), dtype), "bias": zeros((dm,), dtype)}
    return {"scale": zeros((dm,), dtype)}  # rmsnorm stores (scale - 1)


# ---------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotary embedding on split halves. x: [B, S, N, hd]; positions:
    [B, S] int. Angles in fp32 from the positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # [hd/2]
    angles = positions.float()[..., None] * freqs             # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention(q, k, v, *, mask=None, scale: float = None):
    """Reference attention with GQA broadcast, fp32 scores.

    q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] with H % K == 0.
    mask: broadcastable to [B, H, Sq, Sk] (True = attend).
    scale: the scores' factor (None: divided by √hd).

    Both einsums run on fp32 operands (exact for bf16 inputs), as the
    reference's ``preferred_element_type=float32`` does; the
    probabilities are rounded to ``v.dtype`` first, as there, and the
    output is cast to ``q.dtype`` once, at the end.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf.float(), k.float())
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    scores = scores.reshape(B, H, Sq, k.shape[1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.reshape(B, K, G, Sq, k.shape[1])
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def make_attn_mask(pos_q, pos_k, *, causal: bool, window: int = 0,
                   valid_k=None):
    """[B, 1, Sq, Sk] boolean mask from absolute positions.

    window > 0 limits the lookback distance; valid_k [B, Sk] bool marks
    which cache slots are populated.
    """
    dq = pos_q[:, :, None]
    dk = pos_k[:, None, :]
    m = torch.ones(dq.shape[:2] + (pos_k.shape[-1],), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m = m & (dk <= dq)
    if window and window > 0:
        m = m & (dk > dq - window)
    if valid_k is not None:
        m = m & valid_k[:, None, :]
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

def silu(x):
    """``jax.nn.silu``: x·sigmoid(x), the sigmoid as 1 / (1 + e^−x), each op
    rounded in x's dtype as XLA rounds it (``F.silu`` rounds once, so in
    bf16 about a third of its outputs sit one ulp off the reference's).
    ``torch.reciprocal``, not ``1.0 / t``, which PyTorch runs as a
    reciprocal and then a multiply by 1.0: the same bits, one pass more."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def gelu(x):
    """``jax.nn.gelu`` (its default tanh form),
    x·0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³))), each op rounded in x's
    dtype as XLA rounds it: both constants are rounded to that dtype
    first, as the reference's ``np.sqrt(2 / np.pi).astype(x.dtype)`` and
    weak-typed 0.044715 are (a Python float beside a bf16 tensor would
    enter the product unrounded), and x³ is x·x·x. ``F.gelu(x,
    approximate="tanh")`` rounds once, which leaves 43 % of bf16 outputs
    an ulp or more off the reference's; this form matches it bit for bit
    in bf16. In fp32 neither form matches XLA's ``tanh`` in the last ulp
    (both within 1e-6), so fp32 keeps the one fused ``F.gelu`` pass in
    place of the chain's eight."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.nn.functional.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    dm, dff = cfg.d_model, cfg.d_ff
    down_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, dm, dff, dtype),
            "w_up": dense_init(gen, dm, dff, dtype),
            "w_down": dense_init(gen, dff, dm, dtype, scale=down_scale),
        }
    return {  # plain gelu
        "w_up": dense_init(gen, dm, dff, dtype),
        "b_up": zeros((dff,), dtype),
        "w_down": dense_init(gen, dff, dm, dtype, scale=down_scale),
        "b_down": zeros((dm,), dtype),
    }


def mlp_apply(cfg: ModelConfig, p, x):
    if cfg.mlp == "swiglu":
        return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if cfg.mlp == "geglu":
        return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]


# ------------------------------------------------------- blockwise attention

ATTN_BLOCKWISE_THRESHOLD = 4096


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        bq: int = 512, bk: int = 1024, scale: float = None):
    """Online-softmax attention over query and kv blocks, in plain PyTorch:
    never holds more than a [B, H, bq, bk] fp32 score block. The
    reference's path for S >= ATTN_BLOCKWISE_THRESHOLD with the kernels
    off. Positions are arange (prefill self-attention); ``scale`` as in
    ``attention``.

    q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd] -> [B, Sq, H, hd].
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    bq, bk = min(bq, Sq), min(bk, Skv)
    if Sq % bq or Skv % bk:
        raise ValueError(f"blockwise_attention: Sq {Sq} and Skv {Skv} must "
                         f"divide into blocks of {bq} and {bk}")
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dev = q.device
    outs = []
    for i in range(Sq // bq):
        qi = q[:, i * bq:(i + 1) * bq].reshape(B, bq, K, G, hd).float()
        m = torch.full((B, K, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, K, G, bq), device=dev)
        acc = torch.zeros((B, K, G, bq, hd), device=dev)
        rows = i * bq + torch.arange(bq, device=dev)[:, None]
        for j in range(Skv // bk):
            kj = k[:, j * bk:(j + 1) * bk].float()
            vj = v[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale
            cols = j * bk + torch.arange(bk, device=dev)[None, :]
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (cols <= rows)
            if window:
                mask = mask & (cols > rows - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype).float(), vj.float())
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd))
    return torch.cat(outs, dim=1)


# -------------------------------------------------------------------- losses

def softmax_xent(logits, labels, *, valid=None, vocab: int = None):
    """Mean cross-entropy in fp32. logits [..., V]; labels [...] int.

    ``vocab`` masks the padded vocabulary columns (``padded_vocab``);
    ``valid`` (labels' shape) weights the positions, and the mean is over
    its sum (at least 1)."""
    nll = softmax_nll(logits, labels, vocab=vocab)
    if valid is None:
        return nll.mean()
    w = valid.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def softmax_nll(logits, labels, *, vocab: int = None):
    """The fp32 cross-entropy of each position, ``softmax_xent`` before
    its mean."""
    logits = logits.float()
    if vocab is not None and vocab < logits.shape[-1]:
        neg = torch.full(logits.shape[:-1] + (logits.shape[-1] - vocab,),
                         NEG_INF, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :vocab], neg], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold
