"""KV-cache serving path for the dense LM family: prefill + single-token
decode, the attention parts of the JAX package's ``models/decode.py``.

Cache layout (stacked over layers, mirroring the super-network stack):
  k, v  [L, B, W, K, hd]  post-rope keys and values (W = the cache window)
  pos   [B, W] int32      absolute position per slot, -1 = empty
  idx   int               next position to decode

W is the rolling window: ``cache_window`` gives the arch's sliding window
(or ``long_context_window`` past ``LONG_CONTEXT_THRESHOLD``), else the
whole sequence; slot = position % W.

Two deliberate departures from the reference, each held by
``tests/test_torch_decode.py``:
  (c) ``decode_step`` writes the new k, v and pos into the cache IN PLACE
      and returns the same dict; the JAX package returns a new cache. At
      Llama-3.2-3B's full width and 4 × 2080 slots the cache is about
      0.95 GB, and a copy per token would dominate decode.
  (d) ``cache["idx"]`` is a host ``int``, not a device scalar, so the slot
      ``idx % W`` needs no device sync per token.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import (_head_logits, _row, check_family,
                                      embed_inputs, layer_role, run_stack,
                                      torch_dtype)

LONG_CONTEXT_THRESHOLD = 65536


def _check_servable(cfg: ModelConfig) -> None:
    if cfg.family == "vit":
        raise ValueError("encoder-only classifier has no decode path")
    check_family(cfg)


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    w = cfg.sliding_window or 0
    if seq_len > LONG_CONTEXT_THRESHOLD:
        w = w or cfg.long_context_window
    return min(seq_len, w) if w else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cpu") -> Dict[str, Any]:
    """An empty cache for ``batch`` sequences of up to ``seq_len``."""
    _check_servable(cfg)
    W = cache_window(cfg, seq_len)
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = torch_dtype(cfg)
    return {"idx": 0,
            "pos": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _final_norm(cfg: ModelConfig, params, h):
    return L.apply_norm(cfg, h, {f"attn_norm_{k}": v for k, v in
                                 params["final_norm"].items()}, "attn_norm")


# -------------------------------------------------------------------- prefill

def prefill(cfg: ModelConfig, params, batch, decode_budget: int = 0):
    """Teacher-forced full forward that also populates the cache.

    ``decode_budget`` reserves cache room for later ``decode_step`` calls
    (ignored when the rolling window is already smaller than the prompt).
    Returns (logits [B, S, V], cache).
    """
    _check_servable(cfg)
    h, pos = embed_inputs(cfg, params, batch)
    causal = layer_role(cfg) in ("dense", "moe", "hybrid")
    h, _, ys = run_stack(cfg, params["layers"], h, positions=pos,
                         causal=causal, window=cfg.sliding_window, emit=True)
    logits = _head_logits(cfg, params, _final_norm(cfg, params, h))
    cache = _build_cache(cfg, ys, h.shape[0], h.shape[1], decode_budget)
    return logits, cache


def _build_cache(cfg: ModelConfig, ys, batch: int, S: int,
                 decode_budget: int = 0):
    W = cache_window(cfg, S + decode_budget)
    k, v = ys["k"], ys["v"]
    pos = torch.arange(S, dtype=torch.int32, device=k.device).expand(
        batch, S)
    if W > S:  # headroom for decode
        pad = list(k.shape)
        pad[2] = W
        kc = k.new_zeros(pad)
        vc = v.new_zeros(pad)
        kc[:, :, :S] = k
        vc[:, :, :S] = v
        k, v = kc, vc
        pos = torch.cat([pos, pos.new_full((batch, W - S), -1)], dim=1)
    elif W < S:
        # rolling-slot alignment: slot = position % W
        shift = (S - W) % W
        k = torch.roll(k[:, :, S - W:], shift, dims=2)
        v = torch.roll(v[:, :, S - W:], shift, dims=2)
        pos = torch.roll(pos[:, S - W:], shift, dims=1)
    # pos is an expanded view until here; decode writes it in place
    return {"idx": S, "pos": pos.contiguous(), "k": k, "v": v}


# ---------------------------------------------------------------- decode step

def decode_step(cfg: ModelConfig, params, cache, token):
    """token [B, 1] int -> (logits [B, 1, V], cache). The cache is updated
    in place and returned (departure (c)); ``cache["idx"]`` is a host int
    (departure (d))."""
    _check_servable(cfg)
    B = token.shape[0]
    idx = int(cache["idx"])
    h, _ = embed_inputs(cfg, params, {"tokens": token})
    pos_q = torch.full((B, 1), idx, dtype=torch.int32, device=h.device)
    kc_all, vc_all, pos = cache["k"], cache["v"], cache["pos"]
    slot = idx % kc_all.shape[2]
    pos[:, slot] = idx
    mask = (pos >= 0)[:, None, None, :]
    stack = params["layers"]
    for i in range(kc_all.shape[0]):
        p = _row(stack, i)
        x = L.apply_norm(cfg, h, p, "attn_norm")
        q, k, v = L.project_qkv(cfg, p["attn"], x, x)
        q = L.apply_rope(q, pos_q, cfg.rope_theta)
        k = L.apply_rope(k, pos_q, cfg.rope_theta)
        kc_all[i, :, slot] = k[:, 0]
        vc_all[i, :, slot] = v[:, 0]
        out = L.attention(q, kc_all[i], vc_all[i], mask=mask)
        h = h + out.reshape(B, 1, -1) @ p["attn"]["wo"]
        x = L.apply_norm(cfg, h, p, "mlp_norm")
        h = h + L.mlp_apply(cfg, p["mlp"], x)
    logits = _head_logits(cfg, params, _final_norm(cfg, params, h))
    cache["idx"] = idx + 1
    return logits, cache
