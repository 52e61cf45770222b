"""Three-Phase Gradient Fusion (TPGF) — paper §II-B / Algorithm 2.

Phase 1 (client): local head loss, phi_i gradient, clipped encoder grad.
Phase 2 (server): suffix loss, server param grads, g_z returned to the
                  client, and the client backprop of g_z through the
                  encoder.
Phase 3 (client): loss-weighted fusion (Eq. 3/4) of the two encoder grads.
Cross-tier:       ``fuse_tiers`` fuses per-width-tier server updates into
                  ONE full-width update (per-coordinate denominators).

Both encoder gradients come from ONE client-prefix forward (Algorithm 2,
line 13; the reference's single ``jax.vjp``): the smashed data ``z`` is
detached into a leaf that feeds both heads, and two
``torch.autograd.grad(z, client_params, grad_outputs=...)`` calls pull
each head's dL/dz back through the one retained graph.

Everything returns *gradients*; ``repro_torch.optim`` applies them.
``tpgf_grads_split``'s phases are ``repro_torch.trace`` spans
(``tpgf.client_forward``, ``tpgf.local_head``, ``tpgf.server``,
``tpgf.client_backward`` over both pulls, ``tpgf.fuse`` over the clip,
Eqs. 3-4 and the degrade), as is ``tpgf_grads``' merge (``tpgf.merge``).
Phase 3 on the card (``clip_and_fuse``) always runs the hand-written
``sumsq`` and ``fuse`` kernels; the CPU keeps the plain chain.
``tpgf_grads`` and ``local_only_grads`` take and return full-params
trees (the LM train step's form); ``tpgf_grads_split`` works on the
split views (the federated strategies' form).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation as AGG
from repro_torch.core import supernet as SN
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.trace import span
from repro_torch.tree import (grad_leaves, tree_flatten_with_path,
                              tree_leaves, tree_map, tree_unflatten)


class TPGFOut(NamedTuple):
    grads: Dict[str, Any]        # full-params-aligned gradient tree
    loss_client: torch.Tensor
    loss_server: torch.Tensor
    w_client: torch.Tensor
    aux: Any                     # MoE router load-balance loss (prefix)


class TPGFSplitOut(NamedTuple):
    g_client: Dict[str, Any]     # client-view gradient tree
    g_server: Dict[str, Any]     # server-view gradient tree
    g_local: Dict[str, Any]      # phi_i gradient tree
    loss_client: torch.Tensor
    loss_server: torch.Tensor
    w_client: torch.Tensor
    aux: Any


def tpgf_weight(loss_client, loss_server, d_i: int, d_s: int,
                eps: float = 1e-8, variant: str = "full"):
    """Eq. (3): depth-aware x inverse-loss reliability weighting.

    ``variant`` implements the paper's Fig. 6 ablation:
      full     — both factors (the paper's rule)
      no_loss  — depth factor only
      no_depth — loss factor only
      equal    — neither (naive 0.5/0.5 fusion)
    """
    depth = d_i / (d_i + d_s)
    ic = 1.0 / (loss_client + eps)
    is_ = 1.0 / (loss_server + eps)
    loss_term = ic / (ic + is_)
    if variant == "full":
        return depth * loss_term
    if variant == "no_loss":
        return depth + 0.0 * loss_term
    if variant == "no_depth":
        return loss_term
    if variant == "equal":
        return 0.5 + 0.0 * loss_term
    raise ValueError(variant)


def fused_loss(loss_client, loss_server, d_i: int, d_s: int,
               eps: float = 1e-8, variant: str = "full"):
    """The same fusion rule applied to losses (Eq. 6 aggregation weights);
    ``variant`` must match the one the gradients were fused under."""
    w = tpgf_weight(loss_client, loss_server, d_i, d_s, eps, variant)
    return w * loss_client + (1.0 - w) * loss_server


def _fault_degrade(w_c, g_server_params, g_client_local, tau: float):
    """Fault-tolerant degrade (paper §II-C), for a step whose server is
    unreachable: the fusion weight collapses to 1, the encoder takes its
    local-only (Phase-1) gradient, clipped, and the server branch gets a
    zero gradient. Eq. 4 is not computed. Returns (w_c, g_server_params,
    g_client)."""
    g_client, _ = clip_by_global_l2(g_client_local, tau)
    return (torch.ones_like(w_c),
            tree_map(torch.zeros_like, g_server_params), g_client)


def clip_by_global_l2(tree, tau: float):
    """Paper's Phase-1 encoder-gradient clip (tau = 0.5). Each leaf is
    scaled in fp32 and cast back, as the reference's bf16 × f32 product
    promotes (a bf16 leaf times an fp32 device scalar would compute in
    bf16 on the card)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    norm = torch.sqrt(sq)
    scale = torch.clamp(tau / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def fuse_gradients(g_client, g_server, w_client, *, use_pallas: bool = False):
    """Eq. (4): per-leaf fused encoder gradient; ``use_pallas`` routes it
    through the hand-written ``fuse`` kernel (the reference's flag name).
    Sharded gradients (DTensors) reach the kernel through ``local_map``,
    each rank's shards of a leaf in one launch. Phase 3 calls this only
    for gradients off the card or sharded (``clip_and_fuse``); on the
    card it runs the kernels whatever the flag says."""
    w_c = w_client.float()
    if use_pallas and SH.is_dtensor(w_c):
        from torch.distributed.tensor.experimental import local_map
        from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf

        def fuse(a, b):
            pls = list(a.placements)
            return local_map(fuse_leaf, out_placements=pls,
                             in_placements=(pls, list(b.placements),
                                            list(w_c.placements)),
                             device_mesh=a.device_mesh)(a, b, w_c)
        return tree_map(fuse, g_client, g_server)
    if use_pallas:
        from repro_torch.kernels.tpgf_fusion.ops import fuse_tree
        return fuse_tree(g_client, g_server, w_c)
    return tree_map(
        lambda a, b: (w_c * a.float() + (1.0 - w_c) * b.float()).to(a.dtype),
        g_client, g_server)


def clip_and_fuse(g_client_local, g_client_server, w_client, tau: float, *,
                  use_pallas: bool = False):
    """Phase 3: the global-L2 clip of the local encoder gradient at
    ``tau``, then Eq. 4. The route follows the gradients' device, not
    ``use_pallas``. On the card: two hand-written passes,
    ``fuse_tree(tau=)`` (Σx² by ``sumsq``, the clip scale on the device,
    then ``fuse`` once per leaf with the scale applied in registers and
    the fused value rounded once, as the reference's kernel path does).
    On the CPU: the plain chain, ``clip_by_global_l2`` (which rounds the
    clipped gradient to its dtype) then ``fuse_gradients`` (through
    ``fuse``'s plain version under ``use_pallas``). Sharded gradients
    (DTensors) take the plain chain too, their clip norm being a
    cross-rank sum, and reach ``fuse`` under ``use_pallas``."""
    x0 = tree_leaves(g_client_local)[0]
    if x0.device.type == "cuda" and not SH.is_dtensor(x0):
        from repro_torch.kernels.tpgf_fusion.ops import fuse_tree
        return fuse_tree(g_client_local, g_client_server, w_client.float(),
                         tau=tau)
    clipped, _ = clip_by_global_l2(g_client_local, tau)
    return fuse_gradients(clipped, g_client_server, w_client,
                          use_pallas=use_pallas)


def tpgf_grads(cfg: ModelConfig, params, batch, d: int, *,
               server_available=None) -> TPGFOut:
    """One TPGF iteration's gradients for every parameter group of the
    full tree at the static depth ``d``: split, ``tpgf_grads_split``,
    merge (the stack gradient's rows ``[:d]`` are the client's, ``[d:]``
    the server's)."""
    client_p, server_p, local_p = SN.split_params(cfg, params, d)
    out = tpgf_grads_split(cfg, cfg, client_p, server_p, local_p, batch, d,
                           server_available=server_available)
    with span("tpgf.merge"):
        grads = SN.merge_params(cfg, out.g_client, out.g_server,
                                out.g_local)
    return TPGFOut(grads, out.loss_client, out.loss_server, out.w_client,
                   out.aux)


def local_only_grads(cfg: ModelConfig, params, batch, d: int):
    """The fallback step when the server is unreachable (Algorithm 3's
    else-branch): the encoder and the local head trained from the client
    classifier alone, the encoder gradient clipped; the server parameters
    get zero. Returns (grads, loss_client)."""
    client_p, server_p, local_p = SN.split_params(cfg, params, d)
    c_paths, c_leaves = grad_leaves(client_p)
    l_paths, l_leaves = grad_leaves(local_p)
    z, _ = M.client_apply(cfg, tree_unflatten(c_paths, c_leaves), batch)
    loss = M.local_loss(cfg, tree_unflatten(l_paths, l_leaves), z, batch)
    grads = torch.autograd.grad(loss, c_leaves + l_leaves,
                                materialize_grads=True)
    g_client = tree_unflatten(c_paths, grads[:len(c_leaves)])
    g_local = tree_unflatten(l_paths, grads[len(c_leaves):])
    g_client, _ = clip_by_global_l2(g_client, cfg.tpgf_clip)
    zeros_server = tree_map(torch.zeros_like, server_p)
    return (SN.merge_params(cfg, g_client, zeros_server, g_local),
            loss.detach())


def tpgf_grads_split(cfg: ModelConfig, wcfg: ModelConfig, client_p, server_p,
                     local_p, batch, d: int, *,
                     server_available=None) -> TPGFSplitOut:
    """TPGF over an already-split depth-``d`` subnetwork: ``client_p`` holds
    stack rows ``[:d]`` (the ``split_params(cfg, params, d, width)`` client
    view), ``server_p`` rows ``[d:]``. ``wcfg`` is the matching
    ``supernet.width_cfg``: the client forward runs on the slice, while the
    local head and the server suffix stay full width (the smashed data is
    full ``d_model``). ``g_client`` comes back aligned with the slice.

    ``aux`` is the client prefix's MoE router loss, detached: it is a
    metric, and no gradient flows through it (the reference pulls a zero
    cotangent for it); the server's own router loss is inside
    ``loss_server``.

    Phase 3 is ``clip_and_fuse``: on the card the ``sumsq`` and ``fuse``
    kernels, whatever ``cfg.use_pallas`` says; on the CPU the plain chain.
    With ``server_available`` false the local gradient is clipped and Eq.
    4 is skipped (``_fault_degrade``)."""
    d_s = cfg.split_stack_len - d
    c_paths, c_leaves = grad_leaves(client_p)
    s_paths, s_leaves = grad_leaves(server_p)
    l_paths, l_leaves = grad_leaves(local_p)

    # ---- one client-prefix forward (Algorithm 2, line 13)
    with span("tpgf.client_forward"):
        z, aux_prefix = M.client_apply(
            wcfg, tree_unflatten(c_paths, c_leaves), batch)
    z_ = z.detach().requires_grad_(True)

    # ---- Phase 1: local supervision
    with span("tpgf.local_head"):
        loss_client = M.local_loss(cfg, tree_unflatten(l_paths, l_leaves),
                                   z_, batch)
        *g_local, gz_client = torch.autograd.grad(loss_client,
                                                  l_leaves + [z_])

    # ---- Phase 2: server supervision
    # (an ssm_moe view may hold a kind's mixer stack with no rows, which
    # no layer reads: its gradient is materialised as zeros)
    with span("tpgf.server"):
        loss_server = M.server_split_loss(
            cfg, tree_unflatten(s_paths, s_leaves), z_, batch)
        *g_server, gz_server = torch.autograd.grad(
            loss_server, s_leaves + [z_], materialize_grads=True)

    # client backprop of each branch's dL/dz through the one prefix graph
    with span("tpgf.client_backward"):
        g_client_local = torch.autograd.grad(
            z, c_leaves, grad_outputs=gz_client, retain_graph=True,
            materialize_grads=True)
        g_client_server = torch.autograd.grad(
            z, c_leaves, grad_outputs=gz_server, materialize_grads=True)
    g_client_local = tree_unflatten(c_paths, g_client_local)
    g_client_server = tree_unflatten(c_paths, g_client_server)
    g_server_params = tree_unflatten(s_paths, g_server)
    g_local = tree_unflatten(l_paths, g_local)
    if SH.is_dtensor(z):
        # the data ranks' partial sums, reduce-scattered (or all-reduced)
        # to each parameter's own placements
        g_client_local = SH.match_placements(g_client_local, client_p)
        g_client_server = SH.match_placements(g_client_server, client_p)
        g_server_params = SH.match_placements(g_server_params, server_p)
        g_local = SH.match_placements(g_local, local_p)

    # ---- Phase 3: clip + loss-weighted fusion (Eqs. 3-4), or the degrade
    # (``server_available``: the engine's host bool draw; None never
    # degrades)
    with span("tpgf.fuse"):
        loss_client, loss_server = loss_client.detach(), loss_server.detach()
        w_c = tpgf_weight(loss_client, loss_server, d, d_s, cfg.tpgf_eps,
                          variant=cfg.tpgf_variant)
        if server_available is None or bool(server_available):
            g_client = clip_and_fuse(g_client_local, g_client_server, w_c,
                                     cfg.tpgf_clip, use_pallas=cfg.use_pallas)
        else:
            w_c, g_server_params, g_client = _fault_degrade(
                w_c, g_server_params, g_client_local, cfg.tpgf_clip)
    if isinstance(aux_prefix, torch.Tensor):
        aux_prefix = aux_prefix.detach()
    return TPGFSplitOut(g_client, g_server_params, g_local,
                        loss_client, loss_server, w_c, aux_prefix)


# ------------------------------------------------------- cross-tier fusion

class TierUpdate(NamedTuple):
    """One width tier's contribution to :func:`fuse_tiers`.

    width  — host float in (0, 1]: the tier's width slice (1.0 = full);
    weight — fp32 scalar (a device scalar is fine): the tier's mass, the
             Eq. 6-style summed inverse fused losses of its live clients;
             0 means the tier trained nobody and fuses as a no-op;
    tree   — the tier's update tree on its width slice, or full width.
    """
    width: float
    weight: Any
    tree: Any


def fuse_tiers(cfg: ModelConfig, tiers, *, base=None,
               use_pallas: bool = False):
    """Cross-tier TPGF: ONE full-width update from per-tier width slices.

    Each tier's tree is zero-extended to full width (``widen_width``) and
    fused per coordinate with the denominators of
    ``aggregation.width_coord_masks``, so a coordinate is fused only over
    the tiers that hold it:

        fused[f] = sum_t ( w_t * m_t[f] / sum_u w_u * m_u[f] ) * x_t[f]

    The normalizer divides BEFORE the multiply: a coordinate held by one
    tier gets that tier's value exactly (``w/w == 1.0``) and a zero-weight
    tier adds an exact ``+/-0``. Tiers are sorted by width first (stable
    for equal widths), so the result does not depend on the caller's
    order.

    ``base=None`` fuses gradient-like trees: coordinates no tier holds
    come out zero. With ``base`` (delta mode: the server branch and its
    optimizer moments) the result is ``base + sum_t hw_t * (x_t - base)``,
    and un-held coordinates keep ``base`` through a where-guard, so an
    all-zero-weight cohort is a bit-exact no-op.

    ``use_pallas`` sends the scalar-weight leaves through the ``tier_sum``
    kernel; the per-coordinate leaves stay plain PyTorch.
    """
    if not tiers:
        raise ValueError("fuse_tiers needs at least one tier")
    tiers = sorted(tiers, key=lambda t: float(t.width))
    widths = [float(t.width) for t in tiers]
    lifted = [SN.widen_width(cfg, t.tree, t.width) for t in tiers]
    flats = [tree_flatten_with_path(t) for t in lifted]
    dev = flats[0][0][1].device
    wts = [torch.as_tensor(t.weight, dtype=torch.float32, device=dev)
           for t in tiers]

    tot = wts[0]
    for wt in wts[1:]:
        tot = tot + wt
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    safe_tot = torch.where(tot > 0, tot, one)
    coord = any(wi < 1.0 for wi in widths)
    plan = SN.width_plan(cfg, 1.0)
    masks = AGG.width_coord_masks(cfg, widths, device=dev) if coord else {}
    wvec = torch.stack(wts) if coord else None
    hws_full = [torch.where(tot > 0, wt / safe_tot, zero) for wt in wts]
    hw_vec = torch.stack(hws_full) if use_pallas else None
    base_leaves = (None if base is None else
                   [x for _, x in tree_flatten_with_path(base)])

    out = []
    for i, (path, x0) in enumerate(flats[0]):
        name = SN._leaf_name(path)
        xs = [flat[i][1].float() for flat in flats]
        b = None if base_leaves is None else base_leaves[i]
        bf = None if b is None else b.float()
        if coord and name in masks:
            ax, F = plan[name]
            axis = x0.dim() + ax
            den = torch.einsum("t,tf->f", wvec, masks[name])       # [F]
            sden = torch.where(den > 0, den, one)
            shape = [1] * x0.dim()
            shape[axis] = F
            held = (den > 0).reshape(shape)
            acc = None
            for wt, mt, xf in zip(wts, masks[name], xs):
                hw = (wt * mt / sden).reshape(shape)
                term = hw * (xf if bf is None else xf - bf)
                acc = term if acc is None else acc + term
        else:
            held = tot > 0
            terms = xs if bf is None else [xf - bf for xf in xs]
            if use_pallas:
                from repro_torch.kernels.tpgf_fusion.ops import tier_sum_leaf
                acc = tier_sum_leaf(terms, hw_vec)
            else:
                acc = None
                for hw, term in zip(hws_full, terms):
                    acc = hw * term if acc is None else acc + hw * term
        if bf is None:
            fused = torch.where(held, acc, zero)
        else:
            fused = torch.where(held, bf + acc, bf)
        out.append(fused.to(x0.dtype if b is None else b.dtype))
    return tree_unflatten([p for p, _ in flats[0]], out)
