"""Collaborative client-server model aggregation — paper §II-D.

Client weighting (Eq. 6):
    w_i = d_i / sum_j d_j  *  (L_i + eps)^-1 / sum_j (L_j + eps)^-1
with L_i the client loss, or the TPGF-fused loss when the client had
server supervision that round.

Layer-aligned averaging with server consistency (Eq. 7/8, closed form):
    theta_bar^l = (sum_{i has l} w_i theta_i^l + lambda theta_s^l)
                  / (sum_{i has l} w_i + lambda)

Clients are one more leading axis: stacked client params are [N, L, ...]
and presence is an [N, L] mask. With ``use_pallas`` the split-stack
leaves go through the hand-written ``aggregate`` kernel.

When some client trained a width slice (``widths`` < 1), the plan leaves
of the split stack take per-COORDINATE denominators
(``_agg_stacked_width``): a client's weight counts only at the channels
its tier holds. Under ``use_pallas`` the port sends that path's non-plan
leaves (norms, ``b_down``) through the ``aggregate`` kernel as well,
where the reference takes its plain ``_agg_leaf``; no kernel computes
per-coordinate denominators, so the plan leaves stay plain PyTorch.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import supernet as SN
from repro_torch.tree import (tree_flatten_with_path, tree_map,
                              tree_unflatten)


def _as_f32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _as_bool(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return torch.as_tensor(np.asarray(x, bool), device=device)


def client_weights(depths, losses, eps: float = 1e-8, mask=None):
    """Eq. (6). depths [N] int, losses [N] (client or fused) -> [N] fp32.
    ``mask`` ([N] bool) restricts the weighting to the clients that trained
    this round: masked-out entries get weight 0 and add to neither
    normalizer."""
    device = losses.device if isinstance(losses, torch.Tensor) else None
    depths = _as_f32(depths, device)
    losses = _as_f32(losses, device)
    if mask is not None:
        mask = _as_bool(mask, losses.device)
        zero = torch.zeros((), dtype=torch.float32, device=losses.device)
        depths = torch.where(mask, depths, zero)
        inv = torch.where(mask, 1.0 / (losses + eps), zero)
    else:
        inv = 1.0 / (losses + eps)
    depth_term = depths / torch.sum(depths)
    loss_term = inv / torch.sum(inv)
    return depth_term * loss_term


def presence_mask(depths, n_layers: int, device=None):
    """[N, L] bool: client i holds layer l iff l < d_i."""
    depths = torch.as_tensor(np.asarray(depths), device=device)
    return torch.arange(n_layers, device=depths.device)[None, :] \
        < depths[:, None]


def _agg_leaf(client_leaf, server_leaf, w, pres, lam):
    """client_leaf [N, L, ...] or [N, ...]; server_leaf [L, ...] or [...]."""
    cf = client_leaf.float()
    sf = server_leaf.float()
    if client_leaf.dim() == server_leaf.dim() + 1 and pres is not None \
            and client_leaf.shape[1] == pres.shape[1]:
        ww = w[:, None] * pres.float()                        # [N, L]
        num = torch.einsum("nl,nl...->l...", ww, cf)
        den = torch.sum(ww, dim=0)                            # [L]
        den = den.reshape((-1,) + (1,) * (cf.dim() - 2))
        out = (num + lam * sf) / (den + lam)
    else:
        num = torch.einsum("n,n...->...", w, cf)
        out = (num + lam * sf) / (torch.sum(w) + lam)
    return out.to(server_leaf.dtype)


def width_coord_masks(cfg: ModelConfig, widths, device=None):
    """leaf name -> [T, F] fp32 channel-keep masks over the width plan.

    Row ``t`` marks the coordinates a width-``widths[t]`` holder keeps on
    that leaf's sliced axis (kept channel prefix, whole GQA groups). The
    one membership law of both Eq. 8's per-coordinate denominators and
    ``tpgf.fuse_tiers``. ``widths`` are host floats."""
    plan = SN.width_plan(cfg, 1.0)
    keeps = [SN.width_keep_sizes(cfg, float(wi)) for wi in widths]
    out = {}
    for name, (_, full_keep) in plan.items():
        k = np.array([kp[name] for kp in keeps])
        m = (np.arange(full_keep)[None, :] < k[:, None]).astype(np.float32)
        out[name] = torch.as_tensor(m, device=device)
    return out


def _agg_stacked_width(cfg: ModelConfig, leaf_tree, server_tree, w, pres,
                       lam, widths, agg_other):
    """Width-aware Eq. 8 over the split stack: per-coordinate denominators.

    A width-w client's row is zero beyond its kept prefix (the workspace
    writes zeros there), so the numerator is already right; the
    denominator leaves that client's weight out at the coordinates it
    never held. Coordinates no client holds keep the server value
    (``(0 + lam*s)/(0 + lam)``). Non-plan leaves go to ``agg_other``."""
    plan = SN.width_plan(cfg, 1.0)
    chans = width_coord_masks(cfg, widths, device=w.device)
    ww = w[:, None] * pres.float()                              # [N, L]
    flat_s = dict(tree_flatten_with_path(server_tree))
    paths, out = [], []
    for path, c in tree_flatten_with_path(leaf_tree):
        s = flat_s[path]
        name = SN._leaf_name(path)
        paths.append(path)
        if name not in plan:
            out.append(agg_other(c, s))
            continue
        ax, _ = plan[name]
        axis = s.dim() + ax                # sliced axis in the [L, ...] leaf
        F = s.shape[axis]
        num = torch.einsum("nl,nl...->l...", ww, c.float())
        den = torch.einsum("nl,nf->lf", ww, chans[name])
        shape = [1] * s.dim()
        shape[0] = s.shape[0]
        shape[axis] = F
        den = den.reshape(shape)
        out.append(((num + lam * s.float()) / (den + lam)).to(s.dtype))
    return tree_unflatten(paths, out)


def aggregate(cfg: ModelConfig, global_params: Dict[str, Any],
              client_stacks: Dict[str, Any], depths, losses,
              *, lam: float = None, use_pallas: bool = False, mask=None,
              widths=None):
    """Eq. (6)+(8) over the aggregation-eligible (encoder) parameters.

    global_params: the server's current full tree (theta_s source AND the
        carrier of non-aggregated params: server suffix, heads).
    client_stacks: client-stacked client trees — input-side leaves
        [N, ...], split-stack leaves [N, L_full, ...] zero beyond each
        client's depth; ``mask`` marks the rows that trained this round.
    ``widths`` ([N] host floats) switches the split stack to per-coordinate
    denominators when some client is narrower than 1.0.
    Returns (new params, w).
    """
    w = client_weights(depths, losses, cfg.tpgf_eps, mask=mask)
    return aggregate_weighted(cfg, global_params, client_stacks, depths, w,
                              lam=lam, use_pallas=use_pallas,
                              widths=widths), w


def aggregate_weighted(cfg: ModelConfig, global_params: Dict[str, Any],
                       client_stacks: Dict[str, Any], depths, w,
                       *, lam: float = None, use_pallas: bool = False,
                       mask=None, widths=None):
    """Eq. (8)-form layer-aligned averaging with externally supplied client
    weights ``w`` [N]. With a validity ``mask`` the masked-out rows are
    forced to weight 0; ``widths`` as in ``aggregate``."""
    lam = cfg.agg_lambda if lam is None else lam
    w = _as_f32(w)
    if mask is not None:
        w = torch.where(_as_bool(mask, w.device), w,
                        torch.zeros((), dtype=torch.float32, device=w.device))
    pres = presence_mask(depths, cfg.split_stack_len, device=w.device)
    sname = cfg.split_stack_name
    widths = None if widths is None else np.asarray(widths, np.float64)
    width_active = widths is not None and bool((widths < 1.0).any())

    def agg_stacked(c, s):
        if use_pallas and c.dim() >= 3:
            from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
            ww = (w[:, None] * pres.float()).contiguous()
            return aggregate_leaf(c.contiguous(), ww, s.contiguous(), lam)
        return _agg_leaf(c, s, w, pres, lam)

    new_params = dict(global_params)
    for key, leaf_tree in client_stacks.items():
        if key == sname and width_active:
            new_params[key] = _agg_stacked_width(
                cfg, leaf_tree, global_params[key], w, pres, lam, widths,
                agg_stacked)
        elif key == sname:
            new_params[key] = tree_map(agg_stacked, leaf_tree,
                                       global_params[key])
        else:
            new_params[key] = tree_map(
                lambda c, s: _agg_leaf(c, s, w, None, lam),
                leaf_tree, global_params[key])
    return new_params
