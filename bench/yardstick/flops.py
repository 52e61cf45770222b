"""Model FLOPs of one TPGF step, from the configuration and the traffic
alone, never from what the program runs.

TPGF (the paper's Algorithm 2) runs the client prefix forward once and
backward twice, once with the local head's cotangent and once with the
server's, so the reference's 6·N·D rule (``model_flops`` in
``src/repro_torch/roofline/analysis.py`` at commit
c407b0fb230f1fbd6f630de9d44e64d45a4e7d44) undercounts it. Per step, with
T tokens and B samples:

    client prefix               10·N_c·T   (2 forward + 2 × 4 backward)
    local head                   6·N_h·(T, or B where it pools)
    server suffix and its head   6·N_s·T   (+ 6·N_head·B where it pools)

N counts the live weights of the matmuls that every token (or sample)
goes through: the width slice of a narrow client, and the top-k of the E
experts of a mixture (the router counted whole). A multiply-add is 2
FLOPs. The first matmul of a ViT (the patch embedding) needs no gradient
with respect to the pixels, so each of its backward passes counts 2·N·T,
not 4·N·T. A client whose server is unreachable needs only its own
branch: the forward, the local head and one backward pass, 6·N_c·T.

Left out: attention's score and value products (``attention_flops``
gives them, for the comparison with a counted step), norms, softmaxes,
elementwise work and recomputation under ``remat``.
"""
from __future__ import annotations

from typing import Dict

from reference.shapes import head_dim, padded_vocab, split_depth, width_sizes


def _layer_matmul_weights(c: Dict, width: float = 1.0) -> int:
    """Weights a token meets in one layer: q, k, v, o and the MLP, or the
    router and top-k of the experts."""
    dm = c["d_model"]
    s = width_sizes(c, width)
    attn = dm * s["q"] + 2 * dm * s["kv"] + s["q"] * dm
    if c["n_experts"]:
        return attn + dm * c["n_experts"] + c["top_k"] * 3 * dm * s["ff"]
    n_mlp = 3 if c["mlp"] in ("swiglu", "geglu") else 2
    return attn + n_mlp * dm * s["ff"]


def vit_client_step(c: Dict, d: int, width: float, batch: int,
                    available: bool) -> float:
    """One local step of one ViT client of depth ``d`` and width tier
    ``width``: its prefix, its local head and, when it reached the
    server, the server suffix and head."""
    dm, C = c["d_model"], c["n_classes"]
    T = batch * (c["image_size"] // c["patch_size"]) ** 2
    n_pe = c["patch_size"] ** 2 * 3 * dm
    n_layers = d * _layer_matmul_weights(c, width)
    n_head = dm * C
    passes = 2 if available else 1           # backward passes of the prefix
    flops = 2.0 * (n_pe + n_layers) * T      # forward
    flops += passes * (2.0 * n_pe + 4.0 * n_layers) * T
    flops += 6.0 * n_head * batch            # local head, pooled
    if available:
        n_server = (c["n_layers"] - d) * _layer_matmul_weights(c)
        flops += 6.0 * n_server * T + 6.0 * n_head * batch
    return flops


def lm_tpgf_step(c: Dict, tokens: int) -> float:
    """One TPGF train step of a causal LM over ``tokens`` tokens (every
    microbatch together), at the configuration's split depth."""
    d = split_depth(c)
    V = padded_vocab(c)
    dm = c["d_model"]
    n_c = d * _layer_matmul_weights(c)
    n_h = dm * V
    n_s = (c["n_layers"] - d) * _layer_matmul_weights(c) + dm * V
    return (10.0 * n_c + 6.0 * n_h + 6.0 * n_s) * tokens


def attention_flops(c: Dict, layers: int, seq: int, rows: int,
                    passes: int, width: float = 1.0,
                    pairs: int = None) -> float:
    """Score and value products left out above: ``4·hd·H`` FLOPs per
    attended (q, k) pair and layer forward, twice that for each backward
    pass (``passes``). ``pairs`` is the attended pairs of one sequence
    (all ``seq²`` when None); ``rows`` the sequences."""
    hd = head_dim(c)
    H = width_sizes(c, width)["q"] // hd
    pairs = seq * seq if pairs is None else pairs
    return 4.0 * hd * H * pairs * rows * layers * (1 + 2 * passes)
