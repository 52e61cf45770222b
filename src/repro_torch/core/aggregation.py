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
(``_eq8_den``): a client's weight counts only at the channels
its tier holds. Under ``use_pallas`` the port sends that path's non-plan
leaves (norms, ``b_down``) through the ``aggregate`` kernel as well,
where the reference takes its plain ``_agg_leaf``; no kernel computes
per-coordinate denominators, so the plan leaves stay plain PyTorch.

On a fleet mesh (``mesh=`` of extent R > 1) the weights ``w`` are the
whole fleet's, the same on every rank, and ``client_stacks`` holds the
rank's own rows (``launch.sharding.owned_range``). Each rank computes
its rows' numerators ``sum_n ww c`` (the split stack's through the
``aggregate`` kernel's numerator mode under ``use_pallas``), one
all-reduce sums them over the ranks, and every rank divides by the
denominators, which it computes from the global weights: the layer
sums ``sum_n ww`` and the width path's per-coordinate sums alike. Eq. 8's
``(num + lam s) / (den + lam)`` then runs once, elementwise, the same on
every rank.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import supernet as SN
from repro_torch.launch import sharding as SH
from repro_torch.tree import tree_flatten_with_path, tree_get, tree_rebuild


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


def aggregate(cfg: ModelConfig, global_params: Dict[str, Any],
              client_stacks: Dict[str, Any], depths, losses,
              *, lam: float = None, use_pallas: bool = False, mask=None,
              widths=None, mesh=None):
    """Eq. (6)+(8) over the aggregation-eligible (encoder) parameters.

    global_params: the server's current full tree (theta_s source AND the
        carrier of non-aggregated params: server suffix, heads).
    client_stacks: client-stacked client trees — input-side leaves
        [N, ...], split-stack leaves [N, L_full, ...] zero beyond each
        client's depth; ``mask`` marks the rows that trained this round.
    ``widths`` ([N] host floats) switches the split stack to per-coordinate
    denominators when some client is narrower than 1.0. On a fleet
    ``mesh`` ``client_stacks`` holds the rank's own rows (module
    docstring); ``depths``, ``losses`` and ``mask`` are the fleet's.
    Returns (new params, w).
    """
    w = client_weights(depths, losses, cfg.tpgf_eps, mask=mask)
    return aggregate_weighted(cfg, global_params, client_stacks, depths, w,
                              lam=lam, use_pallas=use_pallas,
                              widths=widths, mesh=mesh), w


def aggregate_weighted(cfg: ModelConfig, global_params: Dict[str, Any],
                       client_stacks: Dict[str, Any], depths, w,
                       *, lam: float = None, use_pallas: bool = False,
                       mask=None, widths=None, mesh=None):
    """Eq. (8)-form layer-aligned averaging with externally supplied client
    weights ``w`` [N]. With a validity ``mask`` the masked-out rows are
    forced to weight 0; ``widths`` and ``mesh`` as in ``aggregate``.

    Every leaf is ``(num + lam s) / (den + lam)``: the numerator over
    this rank's rows (every row off a mesh), the denominator from
    :func:`_eq8_den`. Off a fleet mesh the split stack's leaves under
    ``use_pallas`` take the ``aggregate`` kernel, which computes the whole
    quotient; on one, the kernel's numerator mode gives their numerators,
    and one all-reduce sums every leaf's numerator over the ranks before
    the division."""
    lam = cfg.agg_lambda if lam is None else lam
    w = _as_f32(w)
    if mask is not None:
        w = torch.where(_as_bool(mask, w.device), w,
                        torch.zeros((), dtype=torch.float32, device=w.device))
    pres = presence_mask(depths, cfg.split_stack_len, device=w.device)
    widths = None if widths is None else np.asarray(widths, np.float64)
    if widths is not None and not bool((widths < 1.0).any()):
        widths = None
    sharded = SH.fleet_extent(mesh) > 1
    lo, hi = SH.owned_range(w.shape[0], mesh)     # (0, N) off a mesh
    ww = (w[:, None] * pres.float()).contiguous()               # [N, L]
    plan = SN.width_plan(cfg, 1.0) if widths is not None else {}
    chans = (width_coord_masks(cfg, widths, device=w.device)
             if widths is not None else {})
    out, terms = {}, []
    for key, leaf_tree in client_stacks.items():
        for path, c in tree_flatten_with_path(leaf_tree):
            s = tree_get(global_params[key], path)
            kind = _leaf_kind(cfg, key, path, c, s, ww.shape[1], plan)
            if kind == "stacked" and use_pallas and c.dim() >= 3:
                from repro_torch.kernels.layer_aggregate import ops
                if not sharded:           # the kernel's whole quotient
                    out[key, path] = ops.aggregate_leaf(
                        c.contiguous(), ww, s.contiguous(), lam)
                    continue
                num = ops.aggregate_numerator(c.contiguous(),
                                              ww[lo:hi].contiguous())
            elif kind == "other":
                num = torch.einsum("n,n...->...", w[lo:hi], c.float())
            else:
                num = torch.einsum("nl,nl...->l...", ww[lo:hi], c.float())
            terms.append((key, path, s, num,
                          _eq8_den(kind, path, c, s, w, ww, plan, chans)))
    nums = SH.fleet_sum([t[3] for t in terms], mesh)
    for (key, path, s, _, den), num in zip(terms, nums):
        out[key, path] = ((num + lam * s.float()) / (den + lam)).to(s.dtype)
    new_params = dict(global_params)
    for key in client_stacks:
        new_params[key] = tree_rebuild(
            global_params[key], {p: v for (k, p), v in out.items()
                                 if k == key})
    return new_params


def _leaf_kind(cfg: ModelConfig, key, path, c, s, n_layers: int, plan):
    """"width" for a width-plan leaf of the split stack when some client
    is narrower than 1.0 (``plan`` is empty otherwise): per-coordinate
    denominators; "stacked" for the split stack's other ``[N, L, ...]``
    leaves: a client counts only at the layers it holds; "other" for the
    rest."""
    if not (key == cfg.split_stack_name and c.dim() == s.dim() + 1
            and c.shape[1] == n_layers):
        return "other"
    return "width" if SN._leaf_name(path) in plan else "stacked"


def _eq8_den(kind, path, c, s, w, ww, plan, chans):
    """Eq. 8's denominator for one leaf, from the global weights (so it
    needs no collective). A width-w client's row is zero beyond its kept
    prefix (the workspace writes zeros there), so its numerator is
    already right; the width denominator leaves that client's weight out
    at the coordinates it never held, and coordinates no client holds
    keep the server value (``(0 + lam s) / (0 + lam)``)."""
    if kind == "other":
        return torch.sum(w)
    if kind == "stacked":
        return torch.sum(ww, dim=0).reshape((-1,) + (1,) * (c.dim() - 2))
    name = SN._leaf_name(path)
    axis = s.dim() + plan[name][0]         # sliced axis in the [L, ...] leaf
    shape = [1] * s.dim()
    shape[0], shape[axis] = s.shape[0], s.shape[axis]
    return torch.einsum("nl,nf->lf", ww, chans[name]).reshape(shape)
