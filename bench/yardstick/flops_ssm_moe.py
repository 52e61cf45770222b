"""Model FLOPs of one TPGF step of the ssm_moe family (Granite-4.0-H),
from the configuration and the traffic alone, by ``yardstick/flops.py``'s
TPGF rule: per token 10·N_c for the client prefix (a forward and two
backward passes), 6·N_h for the local head and 6·N_s for the server
suffix with its head, N the weights of the matmuls a token goes through.

A layer's N: the Mamba-2 mixer's input and output projections, or
attention's q, k, v and o; the router over all its experts; the shared
expert; and of the routed experts, those live on this card: top_k ×
n_experts / router_experts of them a token on average (10 × 9/72 = 1.25),
whatever the dispatch computes besides. Left out: the scan's products and
attention's score and value products, the conv, norms, softmaxes and
elementwise work, and recomputation under ``remat``.
"""
from __future__ import annotations

from typing import Dict

from reference.shapes import head_dim, padded_vocab, split_depth
from reference.ssm_moe_shapes import ssm_dims


def layer_matmul_weights(c: Dict, kind: str) -> float:
    dm = c["d_model"]
    if kind == "mamba":
        s = ssm_dims(c)
        mixer = dm * (2 * s["din"] + 2 * s["st"] + s["nh"]) + s["din"] * dm
    else:
        hd = head_dim(c)
        q, kv = c["n_heads"] * hd, c["n_kv_heads"] * hd
        mixer = dm * q + 2 * dm * kv + q * dm
    live = c["top_k"] * c["n_experts"] / c["router_experts"]
    return (mixer + dm * c["router_experts"] + 3 * dm * c["shared_expert_ff"]
            + live * 3 * dm * c["d_ff"])


def ssm_moe_tpgf_step(c: Dict, tokens: int) -> float:
    d, kinds = split_depth(c), c["layer_kinds"]
    dm, V = c["d_model"], padded_vocab(c)
    n_c = sum(layer_matmul_weights(c, k) for k in kinds[:d])
    n_s = sum(layer_matmul_weights(c, k) for k in kinds[d:]) + dm * V
    return (10.0 * n_c + 6.0 * dm * V + 6.0 * n_s) * tokens
