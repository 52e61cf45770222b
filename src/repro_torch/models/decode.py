"""KV/SSM-cache serving path for the LM families (dense, moe, vlm, ssm,
hybrid, audio): prefill + single-token decode, the JAX package's
``models/decode.py``. A moe layer attends as a dense one and runs its
mixture of experts on the one new token; a vlm prompt carries its image
patches into the prefill (the cache then starts after ``n_patches + S``
positions), and decode embeds tokens alone. An audio prompt is
``frames`` [B, T_enc, d_model] and decoder ``tokens`` [B, S]: the
prefill runs the encoder once and the decoder over the tokens, and
keeps each decoder layer's cross-attention keys and values over the
frames; decode embeds a token at its ``dec_pos`` row and cross-attends
to that cache, which it reads and never writes.

Cache layout (stacked over layers, mirroring the super-network stack):
  attention:  k, v      [L, B, W, K, hd]  post-rope keys and values
                                          (W = the cache window)
  ssm:        ssm_h     [L, B, nh, hd, st] fp32 recurrent state
              ssm_conv  [L, B, k-1, d_inner] the causal conv's window
  audio:      cross_k/v [L, B, T_enc, K, hd] the decoder's cross-attention
                                          keys and values, set by the
                                          prefill (L: decoder layers)
  shared:     pos       [B, W] int32      absolute position per slot,
                                          -1 = empty (the ssm family
                                          keeps it, padded, unwritten)
              idx       int               next position to decode

W is the rolling window: ``cache_window`` gives the arch's sliding window
(Mixtral's 4,096, or ``long_context_window`` past
``LONG_CONTEXT_THRESHOLD``), else the whole sequence; slot = position % W.
A prompt longer than W keeps its last W positions, rolled so that each
sits in its slot.

Sharded parameters (``launch.sharding``'s LM rules) serve through
``models/sharded.py``: the cache is placed by ``cache_pspecs``, and each
rank writes its shards of it in place.

Two deliberate departures from the reference, each held by
``tests/test_torch_decode.py``:
  (c) ``decode_step`` writes the new k, v and pos, and the new ssm_h and
      ssm_conv, into the cache IN PLACE and returns the same dict; the
      JAX package returns a new cache. At Llama-3.2-3B's full width and
      4 × 2080 slots the KV cache is about 0.95 GB, and at Mamba2-2.7B's
      and B = 4 ``ssm_h`` alone is 671 MB: a copy per token would
      dominate decode. ``cross_k``/``cross_v`` are left as they are, bit
      for bit (at Whisper-small's 12 decoder layers, 1,500 frames and
      B = 16 they are 0.88 GB).
  (d) ``cache["idx"]`` is a host ``int``, not a device scalar, so the slot
      ``idx % W`` needs no device sync per token.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import mesh_of
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.model import (_causal, _head_logits, _row,
                                      check_family, decode_tokens, encode,
                                      embed_inputs, embed_tokens, ffn,
                                      final_norm, layer_role, run_stack,
                                      stack_len, torch_dtype)

LONG_CONTEXT_THRESHOLD = 65536


def _check_servable(cfg: ModelConfig) -> None:
    if cfg.family == "vit":
        raise ValueError("encoder-only classifier has no decode path")
    if cfg.family == "ssm_moe":
        raise NotImplementedError("family='ssm_moe': serving (prefill, "
                                  "decode, its cache) is not ported; it "
                                  "trains through launch.steps")
    check_family(cfg)


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    w = cfg.sliding_window or 0
    if seq_len > LONG_CONTEXT_THRESHOLD:
        w = w or cfg.long_context_window
    return min(seq_len, w) if w else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> Dict[str, Any]:
    """An empty cache for ``batch`` sequences of up to ``seq_len``, on
    ``device`` (None: the card, see ``repro_torch.device``)."""
    _check_servable(cfg)
    device = resolve_device(device)
    role = layer_role(cfg)
    W = cache_window(cfg, seq_len)
    dtype = torch_dtype(cfg)
    c: Dict[str, Any] = {
        "idx": 0,
        "pos": torch.full((batch, W), -1, dtype=torch.int32, device=device)}
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if role in ("dense", "moe", "hybrid") or cfg.is_encdec:
        shape = (cfg.n_layers, batch, W) + kv
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.is_encdec:
        shape = (cfg.n_layers, batch, cfg.enc_frames) + kv
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    if role in ("ssm", "hybrid"):
        c["ssm_h"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=torch.float32, device=device)
        c["ssm_conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv_dim - 1, cfg.ssm_d_inner),
            dtype=dtype, device=device)
    return c


# -------------------------------------------------------------------- prefill

def prefill(cfg: ModelConfig, params, batch, decode_budget: int = 0):
    """Teacher-forced full forward that also populates the cache.

    ``decode_budget`` reserves cache room for later ``decode_step`` calls
    (ignored when the rolling window is already smaller than the prompt).
    A vlm batch holds ``patches`` beside ``tokens``, an audio batch
    ``frames``. Returns (logits [B, S, V], cache), S counting the patches.
    """
    _check_servable(cfg)
    if mesh_of(params) is not None:
        from repro_torch.models import sharded
        return sharded.prefill(cfg, params, batch, decode_budget)
    h, pos = embed_inputs(cfg, params, batch)
    if cfg.is_encdec:
        enc_out, _ = encode(cfg, params, h)
        h, _, ys = decode_tokens(cfg, params, batch["tokens"], enc_out,
                                 emit=True)
    else:
        h, _, ys = run_stack(cfg, params["layers"], h, positions=pos,
                             causal=_causal(cfg), window=cfg.sliding_window,
                             emit=True)
    logits = _head_logits(cfg, params, final_norm(cfg, params, h))
    cache = _build_cache(cfg, ys, h.shape[0], h.shape[1], decode_budget,
                         h.device)
    return logits, cache


def _build_cache(cfg: ModelConfig, ys, batch: int, S: int,
                 decode_budget: int, device):
    W = cache_window(cfg, S + decode_budget)
    c: Dict[str, Any] = {"idx": S}
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(
        batch, S)
    if "k" in ys:
        k, v = ys["k"], ys["v"]
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
        c["k"], c["v"] = k, v
    elif W > S:  # the ssm family keeps pos padded to W, never written
        pos = torch.cat([pos, pos.new_full((batch, W - S), -1)], dim=1)
    elif W < S:  # the reference keeps the first W positions here
        pos = pos[:, :W]
    # pos is an expanded view until here; decode writes it in place
    c["pos"] = pos.contiguous()
    if "ssm_h" in ys:
        c["ssm_h"], c["ssm_conv"] = ys["ssm_h"], ys["ssm_conv"]
    if "cross_k" in ys:
        c["cross_k"], c["cross_v"] = ys["cross_k"], ys["cross_v"]
    return c


# ---------------------------------------------------------------- decode step

def decode_step(cfg: ModelConfig, params, cache, token):
    """token [B, 1] int -> (logits [B, 1, V], cache). The cache is updated
    in place and returned (departure (c)); ``cache["idx"]`` is a host int
    (departure (d)). An audio decoder layer attends over its own cache
    without rope, then cross-attends to ``cross_k``/``cross_v``."""
    _check_servable(cfg)
    if mesh_of(params) is not None:
        from repro_torch.models import sharded
        return sharded.decode_step(cfg, params, cache, token)
    role = "dec" if cfg.is_encdec else layer_role(cfg)
    B = token.shape[0]
    idx = int(cache["idx"])
    h = embed_tokens(cfg, params, token)
    if cfg.is_encdec:
        h = h + params["dec_pos"][idx]
    if "k" in cache:
        pos_q = torch.full((B, 1), idx, dtype=torch.int32, device=h.device)
        kc_all, vc_all, pos = cache["k"], cache["v"], cache["pos"]
        slot = idx % kc_all.shape[2]
        pos[:, slot] = idx
        mask = (pos >= 0)[:, None, None, :]
    stack = params["dec_layers" if cfg.is_encdec else "layers"]
    for i in range(stack_len(stack)):
        p = _row(stack, i)
        x = L.apply_norm(cfg, h, p, "attn_norm")
        if role in ("dense", "moe", "hybrid", "dec"):
            q, k, v = L.project_qkv(cfg, p["attn"], x, x)
            if role != "dec":
                q = L.apply_rope(q, pos_q, cfg.rope_theta)
                k = L.apply_rope(k, pos_q, cfg.rope_theta)
            kc_all[i, :, slot] = k[:, 0]
            vc_all[i, :, slot] = v[:, 0]
            out = L.attention(q, kc_all[i], vc_all[i], mask=mask)
            out = out.reshape(B, 1, -1) @ p["attn"]["wo"]
        if role in ("ssm", "hybrid"):
            # the mixer reads the same normed input as the attention
            s, st = SSM.ssm_decode_step(
                cfg, p["ssm"], x, {"h": cache["ssm_h"][i],
                                   "conv": cache["ssm_conv"][i]})
            cache["ssm_h"][i] = st["h"]
            cache["ssm_conv"][i] = st["conv"]
        if role in ("dense", "moe", "dec"):
            h = h + out
        elif role == "ssm":
            h = h + s
        else:
            h = h + p["branch_scale_attn"] * out + \
                p["branch_scale_ssm"] * s
        if role == "dec":
            x = L.apply_norm(cfg, h, p, "cross_norm")
            q = (x @ p["cross"]["wq"]).reshape(B, 1, cfg.n_heads,
                                               cfg.resolved_head_dim)
            out = L.attention(q, cache["cross_k"][i], cache["cross_v"][i])
            h = h + out.reshape(B, 1, -1) @ p["cross"]["wo"]
        if role != "ssm":
            h = ffn(cfg, role, p, h)[0]
    logits = _head_logits(cfg, params, final_norm(cfg, params, h))
    cache["idx"] = idx + 1
    return logits, cache
