"""Weight-sharing super-network: parameter views for the client/server split.

A client subnetwork of depth ``d`` is a contiguous prefix of the split
stack (paper §II-A): rows ``[:d]`` of every stacked leaf, plus the
input-side parameters (patch embedding, position embedding) that every
client holds. ``split_params``/``merge_params`` give disjoint
client | server | local views, so TPGF can take per-branch gradients.

The width views (``width_cfg``, ``slice_width`` and the rest) come with
the next slice of the port (ROADMAP queue 1: the width supernet).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

# input-side parameter names that always live on the client
_CLIENT_INPUT_KEYS = ("embed", "vision_proj", "patch_embed", "patch_bias",
                      "pos_embed", "frame_proj")
# the fault-tolerant classifier phi_i — never aggregated (paper §II-D)
_LOCAL_KEYS = ("local_head", "local_head_bias")


def split_stack_name(cfg: ModelConfig) -> str:
    return "enc_layers" if cfg.is_encdec else "layers"


def prefix(stack, d: int):
    return tree_map(lambda x: x[:d], stack)


def suffix(stack, d: int):
    return tree_map(lambda x: x[d:], stack)


def split_params(cfg: ModelConfig, params: Params,
                 d=None) -> Tuple[Params, Params, Params]:
    """-> (client theta_i, server theta_s, local phi_i), disjoint views.

    An int ``d`` slices the depth window: the client stack holds rows
    ``[:d]`` and the server stack rows ``[d:]``. ``d=None`` keeps all
    ``L`` rows on both sides (shape templates). The leaves are views of
    ``params``, not copies.
    """
    sname = split_stack_name(cfg)
    client: Params = {}
    server: Params = {}
    local: Params = {}
    for k, v in params.items():
        if k in _LOCAL_KEYS:
            local[k] = v
        elif k == sname:
            client[k] = v if d is None else prefix(v, d)
            server[k] = v if d is None else suffix(v, d)
        elif k in _CLIENT_INPUT_KEYS and not (cfg.is_encdec and k == "embed"):
            client[k] = v
        else:
            server[k] = v
    return client, server, local


def merge_params(cfg: ModelConfig, client: Params, server: Params,
                 local: Params) -> Params:
    """Inverse of ``split_params`` on depth-sliced views: the two stack
    slices concatenate back."""
    sname = split_stack_name(cfg)
    out: Params = {}
    for k, v in client.items():
        if k == sname:
            out[k] = tree_map(lambda a, b: torch.cat([a, b], dim=0),
                              v, server[k])
        else:
            out[k] = v
    for k, v in server.items():
        if k not in out:
            out[k] = v
    out.update(local)
    return out


def client_param_bytes(cfg: ModelConfig, params: Params, d: int) -> int:
    """Size of a depth-``d`` subnetwork — the per-round download cost."""
    client, _, local = split_params(cfg, params, d)
    leaves = tree_leaves(client) + tree_leaves(local)
    return sum(int(x.numel()) * x.element_size() for x in leaves)
