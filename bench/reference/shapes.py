"""The parameter trees of the benchmark's two model kinds, from a
configuration file's sizes alone: the leaf names, shapes and initial
distributions that the benchmark draws its weights in, that the plain
references compute with, and that the yardstick counts FLOPs over.

Trees are nested dicts; a leaf is ``Leaf(shape, init, scale)``. Stacked
layer leaves carry a leading ``n_layers`` axis. The key names are those
the measured program uses, so a tree drawn here can be handed to it
leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    init: str            # "normal", "zeros" or "ones"
    scale: float = 0.0


def head_dim(c: Dict) -> int:
    return c["head_dim"] or c["d_model"] // max(c["n_heads"], 1)


def padded_vocab(c: Dict) -> int:
    return ((c["vocab"] + 255) // 256) * 256


def split_depth(c: Dict) -> int:
    """The LM train step's client depth: ``split_depth`` or a quarter of
    the stack, at least 1 and below the stack's length."""
    n = c["n_layers"]
    d = c["split_depth"] or max(n // 4, 1)
    return min(max(d, 1), n - 1) if n > 1 else 1


def width_sizes(c: Dict, width: float) -> Dict[str, int]:
    """The kept sizes of a width tier (the supernet's width slice): whole
    KV groups, ``round(w·K)`` KV heads (at least 1) and ``round(w·d_ff)``
    hidden channels (at least 1)."""
    hd = head_dim(c)
    H, K, dff = c["n_heads"], c["n_kv_heads"], c["d_ff"]
    if width >= 1.0:
        return {"q": H * hd, "kv": K * hd, "ff": dff}
    group = max(1, H // max(1, K))
    kv = max(1, int(round(width * K)))
    return {"q": group * kv * hd, "kv": kv * hd,
            "ff": max(1, int(round(width * dff)))}


def _normal(shape, scale=0.02):
    return Leaf(tuple(shape), "normal", scale)


def _zeros(shape):
    return Leaf(tuple(shape), "zeros")


def _ones(shape):
    return Leaf(tuple(shape), "ones")


def vit_tree(c: Dict) -> Dict:
    """The ViT classifier: patch embedding, the encoder stack (layer norm,
    multi-head attention without biases, a gelu MLP with biases), the
    mean-pooled head, and the global tree's copy of the local head."""
    L, dm, dff, C = c["n_layers"], c["d_model"], c["d_ff"], c["n_classes"]
    hd = head_dim(c)
    qh, kvh = c["n_heads"] * hd, c["n_kv_heads"] * hd
    pdim = c["patch_size"] ** 2 * 3
    n_patch = (c["image_size"] // c["patch_size"]) ** 2
    down = 0.02 / math.sqrt(2 * L)
    return {
        "patch_embed": _normal((pdim, dm)),
        "patch_bias": _zeros((dm,)),
        "pos_embed": _normal((n_patch, dm)),
        "layers": {
            "attn_norm_scale": _ones((L, dm)),
            "attn_norm_bias": _zeros((L, dm)),
            "attn": {"wq": _normal((L, dm, qh)), "wk": _normal((L, dm, kvh)),
                     "wv": _normal((L, dm, kvh)),
                     "wo": _normal((L, qh, dm), down)},
            "mlp_norm_scale": _ones((L, dm)),
            "mlp_norm_bias": _zeros((L, dm)),
            "mlp": {"w_up": _normal((L, dm, dff)), "b_up": _zeros((L, dff)),
                    "w_down": _normal((L, dff, dm), down),
                    "b_down": _zeros((L, dm))},
        },
        "head": _normal((dm, C)),
        "head_bias": _zeros((C,)),
        "local_head": _normal((dm, C)),
        "local_head_bias": _zeros((C,)),
    }


def vit_head_tree(c: Dict, n_clients: int) -> Dict:
    """The clients' local heads phi_i, stacked on a leading client axis."""
    dm, C = c["d_model"], c["n_classes"]
    return {"local_head": _normal((n_clients, dm, C)),
            "local_head_bias": _zeros((n_clients, C))}


def moe_tree(c: Dict) -> Dict:
    """The mixture-of-experts causal LM (Mixtral's block): token
    embedding, per layer an RMS norm (stored as scale − 1), rope'd GQA
    attention, an RMS norm, a top-k router and E SwiGLU experts; the final
    norm, the untied head, and the client's local head over the
    vocabulary."""
    L, dm, dff, E = c["n_layers"], c["d_model"], c["d_ff"], c["n_experts"]
    hd = head_dim(c)
    qh, kvh = c["n_heads"] * hd, c["n_kv_heads"] * hd
    V = padded_vocab(c)
    down = 0.02 / math.sqrt(2 * L)
    return {
        "embed": _normal((V, dm)),
        "layers": {
            "attn_norm_scale": _zeros((L, dm)),
            "attn": {"wq": _normal((L, dm, qh)), "wk": _normal((L, dm, kvh)),
                     "wv": _normal((L, dm, kvh)),
                     "wo": _normal((L, qh, dm), down)},
            "mlp_norm_scale": _zeros((L, dm)),
            "moe": {"router": _normal((L, dm, E)),
                    "w_gate": _normal((L, E, dm, dff)),
                    "w_up": _normal((L, E, dm, dff)),
                    "w_down": _normal((L, E, dff, dm), down)},
        },
        "final_norm": {"scale": _zeros((dm,))},
        "unembed": _normal((dm, V)),
        "local_head": _normal((dm, V)),
    }


def leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def vit_client_elems(c: Dict, d: int, width: float) -> int:
    """Elements of a ViT client's depth-``d`` prefix at width tier
    ``width``: the input-side leaves and stack rows [:d], each stacked
    leaf cut to the tier (leading channels, whole heads)."""
    s = width_sizes(c, width)
    dm, hd = c["d_model"], head_dim(c)
    n_in = c["patch_size"] ** 2 * 3 * dm + dm \
        + (c["image_size"] // c["patch_size"]) ** 2 * dm
    layer = (4 * dm                                   # the two layer norms
             + dm * s["q"] + 2 * dm * s["kv"] + s["q"] * dm
             + dm * s["ff"] + s["ff"] + s["ff"] * dm + dm)
    return n_in + d * layer


def vit_server_elems(c: Dict, d: int) -> int:
    """Elements of the server branch of a depth-``d`` cohort: stack rows
    [d:] at full width and the head."""
    layer = vit_client_elems(c, 1, 1.0) - vit_client_elems(c, 0, 1.0)
    return (c["n_layers"] - d) * layer + c["d_model"] * c["n_classes"] \
        + c["n_classes"]
