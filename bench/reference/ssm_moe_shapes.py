"""The parameter tree of the ssm_moe family (Granite-4.0-H), from a
configuration file's sizes alone: the leaf names, shapes and initial
distributions that the benchmark draws its weights in
(``traffic/ssm_moe_weights.py``), that the plain reference computes with
and that the yardstick counts FLOPs over. The key names are those the
measured program uses, so a tree drawn here can be handed to it leaf for
leaf.

Leaves with a row for every layer: the RMS norms before the mixer and
before the experts (stored as scale − 1) and the ``moe`` (the router over
all ``router_experts``, the ``n_experts`` SwiGLU experts held here, the
shared SwiGLU). Each kind's mixers are stacked over that kind's layers
alone, in published order: ``mamba`` (one input projection to z, x, B,
C and dt; the causal conv over x, B and C; dt's bias, A's log, D, the
gated norm's scale − 1, the output projection) and ``attention`` (GQA
q, k, v, o, no bias).
"""
from __future__ import annotations

import math
from typing import Dict

from reference.shapes import Leaf, head_dim, padded_vocab

KINDS = ("mamba", "attention")


def ssm_dims(c: Dict) -> Dict[str, int]:
    """The Mamba-2 mixer's sizes: d_inner, heads, head size, state, conv
    width."""
    din = c["ssm_expand"] * c["d_model"]
    return {"din": din, "nh": din // c["ssm_head_dim"],
            "hd": c["ssm_head_dim"], "st": c["ssm_state"],
            "k": c["ssm_conv_dim"]}


def kind_rows(c: Dict, kind: str, lo: int = 0, hi: int = None) -> int:
    """The layers of ``kind`` among layers [lo:hi]."""
    return list(c["layer_kinds"][lo:hi]).count(kind)


def ssm_moe_tree(c: Dict) -> Dict:
    L, dm, dff = c["n_layers"], c["d_model"], c["d_ff"]
    E, R, sff = c["n_experts"], c["router_experts"], c["shared_expert_ff"]
    s = ssm_dims(c)
    din, nh, st, k = s["din"], s["nh"], s["st"], s["k"]
    nm, na = kind_rows(c, "mamba"), kind_rows(c, "attention")
    hd = head_dim(c)
    qh, kvh = c["n_heads"] * hd, c["n_kv_heads"] * hd
    V = padded_vocab(c)
    down = 0.02 / math.sqrt(2 * L)
    normal, zeros = (lambda *sh, scale=0.02: Leaf(sh, "normal", scale),
                     lambda *sh: Leaf(sh, "zeros"))
    return {
        "embed": normal(V, dm),
        "layers": {
            "attention": {"wk": normal(na, dm, kvh), "wo": normal(na, qh, dm,
                                                                 scale=down),
                          "wq": normal(na, dm, qh), "wv": normal(na, dm, kvh)},
            "ffn_norm_scale": zeros(L, dm),
            "mamba": {
                "A_log": Leaf((nm, nh), "A_log"),
                "D": Leaf((nm, nh), "ones"),
                "conv_b": zeros(nm, din + 2 * st),
                "conv_w": normal(nm, k, din + 2 * st, scale=0.1),
                "dt_bias": Leaf((nm, nh), "dt_bias"),
                "gate_norm_scale": zeros(nm, din),
                "w_in": normal(nm, dm, 2 * din + 2 * st + nh),
                "w_out": normal(nm, din, dm, scale=down)},
            "mixer_norm_scale": zeros(L, dm),
            "moe": {"router": normal(L, dm, R),
                    "shared": {"w_down": normal(L, sff, dm, scale=down),
                               "w_gate": normal(L, dm, sff),
                               "w_up": normal(L, dm, sff)},
                    "w_down": normal(L, E, dff, dm, scale=down),
                    "w_gate": normal(L, E, dm, dff),
                    "w_up": normal(L, E, dm, dff)},
        },
        "final_norm": {"scale": zeros(dm)},
        "unembed": normal(dm, V),
        "local_head": normal(dm, V),
    }
