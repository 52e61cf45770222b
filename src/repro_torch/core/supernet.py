"""Weight-sharing super-network: parameter views for the client/server split.

A client subnetwork of depth ``d`` is a contiguous prefix of the split
stack (paper §II-A): rows ``[:d]`` of every stacked leaf, plus the
input-side parameters (patch embedding, position embedding) that every
client holds. ``split_params``/``merge_params`` give disjoint
client | server | local views, so TPGF can take per-branch gradients.

Beside depth, the supernet slices width (paper §II-A, Fig. 2): a width
tier ``w in (0, 1]`` keeps the leading-channel prefix of every layer's
MLP hidden dim and attention heads (whole GQA groups, so a kept query
head never reads a pruned KV head). ``width_cfg`` gives the sliced
config, ``width_plan`` the sliced (axis, keep) per leaf name, and the
four views are:

  slice  — take the kept prefix (the client's download; a view);
  mask   — zero the pruned coordinates of a full tree;
  widen  — zero-embed a sliced tree back to full shape
           (``widen(slice(t)) == mask(t)``);
  scatter— write a sliced tree into a full one, touching ONLY the kept
           coordinates.

The residual stream (``d_model``, the smashed data) is full width at
every tier, so the server branch and the local head never slice.

An ``ssm_moe`` stack (layers of two kinds in a published order) has
leaves with a row for every layer and, for each kind, a mixer stack
with a row for each layer of that kind: ``depth_window`` cuts the first
at the depth and each mixer stack at the number of its kind's layers
below it. It trains at full width only.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import LAYER_KINDS, ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

# input-side parameter names that always live on the client
_CLIENT_INPUT_KEYS = ("embed", "vision_proj", "patch_embed", "patch_bias",
                      "pos_embed", "frame_proj")
# the fault-tolerant classifier phi_i — never aggregated (paper §II-D)
_LOCAL_KEYS = ("local_head", "local_head_bias")


def depth_window(cfg: ModelConfig, stack, lo: int, hi: int = None):
    """Layers ``[lo:hi]`` of the split stack (views). An ssm_moe stack's
    mixer stack of each kind is cut at the number of that kind's layers
    below ``lo`` and ``hi``."""
    if cfg.family != "ssm_moe":
        return tree_map(lambda x: x[lo:hi], stack)

    def below(kind, i):
        return None if i is None else cfg.layer_kinds[:i].count(kind)

    return {k: (tree_map(lambda x: x[below(k, lo):below(k, hi)], v)
                if k in LAYER_KINDS else tree_map(lambda x: x[lo:hi], v))
            for k, v in stack.items()}


# --------------------------------------------------------------- width views

def width_cfg(cfg: ModelConfig, width: float) -> ModelConfig:
    """The sliced ``ModelConfig`` of width tier ``width``: ``Kw = max(1,
    round(w * n_kv_heads))`` KV heads, ``(n_heads // n_kv_heads) * Kw``
    query heads, ``max(1, round(w * d_ff))`` hidden channels. ``head_dim``
    is pinned (``resolved_head_dim`` would recompute it from the sliced
    ``n_heads``)."""
    if width >= 1.0:
        return cfg
    if cfg.family == "ssm_moe":
        raise NotImplementedError("family='ssm_moe' at width < 1: not "
                                  "ported (it trains at full width)")
    hd = cfg.resolved_head_dim
    group = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    kv = max(1, int(round(width * cfg.n_kv_heads)))
    dff = max(1, int(round(width * cfg.d_ff)))
    return cfg.replace(n_heads=group * kv, n_kv_heads=kv, d_ff=dff,
                       head_dim=hd)


def width_plan(cfg: ModelConfig, width: float) -> Dict[str, Tuple[int, int]]:
    """leaf name -> (axis, keep): the sliced axis (negative, so one plan
    covers ``[...]``, ``[L, ...]`` and ``[N, L, ...]`` leaves) and the kept
    prefix length. Names absent from the plan (norms, ``b_down``,
    input-side and head parameters) live on the ``d_model`` residual
    stream and stay full width."""
    wcfg = width_cfg(cfg, width)
    hd = cfg.resolved_head_dim
    qh = wcfg.n_heads * hd
    kvh = wcfg.n_kv_heads * hd
    dff = wcfg.d_ff
    return {
        "wq": (-1, qh), "bq": (-1, qh),
        "wk": (-1, kvh), "wv": (-1, kvh), "bk": (-1, kvh), "bv": (-1, kvh),
        "wo": (-2, qh),
        "w_gate": (-1, dff), "w_up": (-1, dff), "b_up": (-1, dff),
        "w_down": (-2, dff),
    }


def _leaf_name(path) -> Any:
    return path[-1]


def _map_named(tree, fn, name=None):
    """``fn(name, leaf)`` over a nested-dict tree; ``name`` is the key the
    leaf sits under (its ``_leaf_name``)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def _map_width(cfg: ModelConfig, tree, width: float, fn):
    """``fn(leaf, axis, keep)`` on every plan leaf, identity elsewhere."""
    plan = width_plan(cfg, width)
    return _map_named(tree, lambda name, x: fn(x, *plan[name])
                      if name in plan else x)


def slice_width(cfg: ModelConfig, tree, width: float):
    """Kept-prefix view of a full-width tree (views, not copies)."""
    if width >= 1.0:
        return tree
    return _map_width(cfg, tree, width,
                      lambda x, ax, keep: x.narrow(x.dim() + ax, 0, keep))


def mask_width(cfg: ModelConfig, tree, width: float):
    """Zero the pruned coordinates of a full-width tree (NaN-safe)."""
    if width >= 1.0:
        return tree

    def mask(x, ax, keep):
        axis = x.dim() + ax
        kept = torch.arange(x.shape[axis], device=x.device) < keep
        kept = kept.reshape((-1,) + (1,) * (x.dim() - 1 - axis))
        return torch.where(kept, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    return _map_width(cfg, tree, width, mask)


def widen_width(cfg: ModelConfig, tree, width: float):
    """Zero-embed a sliced tree back to full width (``widen(slice(t)) ==
    mask(t)``)."""
    if width >= 1.0:
        return tree
    full = width_plan(cfg, 1.0)
    plan = width_plan(cfg, width)

    def widen(name, x):
        if name not in plan:
            return x
        ax, keep = plan[name]
        shape = list(x.shape)
        shape[x.dim() + ax] = full[name][1]
        out = x.new_zeros(shape)
        out.narrow(x.dim() + ax, 0, keep).copy_(x)
        return out

    return _map_named(tree, widen)


def scatter_width(cfg: ModelConfig, full_tree, sliced_tree, width: float):
    """Write a sliced tree into a copy of a full-width one, touching ONLY
    the kept coordinates of plan leaves; non-plan leaves are held whole by
    the client, so they are replaced."""
    if width >= 1.0:
        return sliced_tree
    plan = width_plan(cfg, width)

    def walk(f, s, name):
        if isinstance(f, dict):
            return {k: walk(f[k], s[k], k) for k in f}
        if name not in plan:
            return s.to(f.dtype)
        ax, keep = plan[name]
        out = f.clone()
        out.narrow(f.dim() + ax, 0, keep).copy_(s)
        return out

    return walk(full_tree, sliced_tree, None)


def width_keep_sizes(cfg: ModelConfig, width: float) -> Dict[str, int]:
    """leaf name -> kept prefix length (host-side, for the per-coordinate
    denominators in ``core.aggregation``)."""
    return {k: keep for k, (_, keep) in width_plan(cfg, width).items()}


def split_params(cfg: ModelConfig, params: Params, d=None,
                 width: float = 1.0) -> Tuple[Params, Params, Params]:
    """-> (client theta_i, server theta_s, local phi_i), disjoint views.

    An int ``d`` slices the depth window: the client stack holds rows
    ``[:d]`` and the server stack rows ``[d:]``. ``d=None`` keeps all
    ``L`` rows on both sides (shape templates). ``width < 1`` width-slices
    the CLIENT stack only: the smashed data is full ``d_model``, so the
    server suffix and the local head stay full width. The leaves are
    views of ``params``, not copies.
    """
    sname = cfg.split_stack_name
    client: Params = {}
    server: Params = {}
    local: Params = {}
    for k, v in params.items():
        if k in _LOCAL_KEYS:
            local[k] = v
        elif k == sname:
            client[k] = slice_width(
                cfg, v if d is None else depth_window(cfg, v, 0, d), width)
            server[k] = v if d is None else depth_window(cfg, v, d)
        elif k in _CLIENT_INPUT_KEYS and not (cfg.is_encdec and k == "embed"):
            client[k] = v
        else:
            server[k] = v
    return client, server, local


def merge_params(cfg: ModelConfig, client: Params, server: Params,
                 local: Params) -> Params:
    """Inverse of ``split_params`` on depth-sliced views: the two stack
    slices concatenate back (an ssm_moe stack's kind stacks too, each at
    its own cut)."""
    sname = cfg.split_stack_name
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


def client_param_bytes(cfg: ModelConfig, params: Params, d: int,
                       width: float = 1.0) -> int:
    """Size of a (depth, width) subnetwork — the per-round download
    cost."""
    client, _, local = split_params(cfg, params, d, width)
    leaves = tree_leaves(client) + tree_leaves(local)
    return sum(int(x.numel()) * x.element_size() for x in leaves)
