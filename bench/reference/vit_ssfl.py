"""Plain reference of SuperSFL rounds of the ViT classifier (the paper's
main path), in PyTorch with no kernels, no batching over clients and no
code of the measured program.

One round, as the paper states it:

* Eq. 1: each client's depth from its memory and latency profile,
  ``min(floor(a·m) + floor(b·(lat_max − lat)/(lat_max − lat_min + eps)),
  L − 1)``, at least 1, in float32; on a width ladder each client's tier
  from its memory's place in [2, 16] GB, the smallest to the narrowest.
* Clients train in cohorts of one depth, shallowest first, each from the
  round's global model: its depth-d prefix at its width (leading
  channels and whole heads kept), its own local head phi_i. A cohort's
  clients of one width form a group; each group trains the server
  suffix (rows [d:] and the head) from the round's global model.
* A local step (Algorithm 2): one prefix forward; the local head's loss
  and the server suffix's loss on the same smashed data; the prefix's
  gradient from each; the local one clipped to global L2 norm tau; the
  two fused by Eq. 3-4, w = d/L · (1/(l_c+eps)) / (1/(l_c+eps) +
  1/(l_s+eps)). A client whose server is unreachable takes its clipped
  local gradient alone and gives the server nothing. SGD on the prefix
  and phi_i per client; the server takes one SGD step per local step
  with the mean over the group's clients of their server gradients
  (unreachable ones count as zero), and none if nobody reached it.
* A client's loss is its last step's fused loss w·l_c + (1 − w)·l_s, or
  l_c if it did not reach the server.
* Groups of one cohort fuse into one server update (delta form):
  base + Σ_t m_t/Σm · (x_t − base), m_t the sum of 1/(loss + eps) over
  the group's clients that reached the server; with no mass the base.
* Each cohort's server rows [d:] and head replace those of the running
  server view, shallowest cohort first.
* Eq. 6 and 8: w_i = d_i/Σd · (1/(L_i+eps))/Σ(1/(L+eps)) over the
  clients that trained; each client parameter becomes (Σ_i w_i c_i +
  lam·s)/(Σ_i w_i + lam), over the clients that hold that layer (and,
  on a width ladder, that coordinate); s the server view's value.
* The round's loss is the mean of the trained clients' losses; its
  traffic 2 × (client prefix and local head bytes) per client plus, per
  local step, 2 × the smashed batch (fp32) for a client that reached the
  server.

All arithmetic is fp32 (``prec`` rounds the matrix products' operands
for the lower-precision control).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reference.precision import mm
from reference.shapes import head_dim, vit_client_elems, width_sizes

MB = 1024 * 1024


# ----------------------------------------------------------------- fleet

def eq1_depths(mem_gb, lat_ms, n_layers: int, alpha: float, beta: float,
               eps: float = 1e-8) -> np.ndarray:
    f32 = np.float32
    mem = np.asarray(mem_gb, f32)
    lat = np.asarray(lat_ms, f32)
    lat_term = np.floor(f32(beta) * (lat.max() - lat)
                        / (lat.max() - lat.min() + f32(eps)))
    d = np.minimum(np.floor(f32(alpha) * mem) + lat_term, f32(n_layers - 1))
    return np.maximum(d, f32(1)).astype(np.int64)


def ladder_widths(mem_gb, tiers, lo: float = 2.0, hi: float = 16.0):
    tiers = sorted(float(t) for t in tiers)
    frac = np.clip((np.asarray(mem_gb, np.float64) - lo) / (hi - lo), 0, 1)
    idx = np.minimum((frac * len(tiers)).astype(int), len(tiers) - 1)
    return np.asarray(tiers)[idx]


# ----------------------------------------------------------------- model

def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _layer(c, p, h, prec):
    """One encoder layer on h [B, T, dm]; ``p`` holds the layer's
    (possibly width-sliced) leaves."""
    B, T, dm = h.shape
    hd = head_dim(c)
    x = _layernorm(h, p["attn_norm_scale"], p["attn_norm_bias"])
    q = mm(x, p["wq"], prec).reshape(B, T, -1, hd).transpose(1, 2)
    k = mm(x, p["wk"], prec).reshape(B, T, -1, hd).transpose(1, 2)
    v = mm(x, p["wv"], prec).reshape(B, T, -1, hd).transpose(1, 2)
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    att = torch.softmax(mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd), -1)
    o = mm(att, v, prec).transpose(1, 2).reshape(B, T, -1)
    h = h + mm(o, p["wo"], prec)
    x = _layernorm(h, p["mlp_norm_scale"], p["mlp_norm_bias"])
    u = torch.nn.functional.gelu(mm(x, p["w_up"], prec) + p["b_up"],
                                 approximate="tanh")
    return h + mm(u, p["w_down"], prec) + p["b_down"]


def _patches(c, images):
    B, H, W, C = images.shape
    ps = c["patch_size"]
    x = images.reshape(B, H // ps, ps, W // ps, ps, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // ps) * (W // ps), -1)


def _xent(logits, labels):
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).mean()


def _flat_layer(tree, l):
    """Layer ``l``'s leaves of a stacked tree, flattened to one dict."""
    out = {}
    for path, x in _items(tree):
        out[path[-1]] = x[l]
    return out


def _items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# where each stacked leaf is cut by a width tier: (axis, size key)
_CUT = {"wq": (-1, "q"), "wk": (-1, "kv"), "wv": (-1, "kv"),
        "wo": (-2, "q"), "w_up": (-1, "ff"), "b_up": (-1, "ff"),
        "w_down": (-2, "ff")}


def client_slice(c, params, d: int, width: float) -> Dict[str, torch.Tensor]:
    """The client's download: input-side leaves and stack rows [:d], each
    cut to the width tier; a flat dict of fresh fp32 tensors."""
    keep = width_sizes(c, width)
    out = {"patch_embed": params["patch_embed"].clone(),
           "patch_bias": params["patch_bias"].clone(),
           "pos_embed": params["pos_embed"].clone()}
    for path, x in _items(params["layers"]):
        x = x[:d]
        name = path[-1]
        if name in _CUT:
            ax, key = _CUT[name]
            x = x.narrow(x.dim() + ax, 0, keep[key])
        out["layers/" + "/".join(path)] = x.clone()
    return out


def _client_forward(c, cp, images, d, prec):
    h = mm(_patches(c, images), cp["patch_embed"], prec) \
        + cp["patch_bias"] + cp["pos_embed"]
    for l in range(d):
        p = {k.split("/")[-1]: v[l] for k, v in cp.items()
             if k.startswith("layers/")}
        h = _layer(c, p, h, prec)
    return h


def _server_forward(c, sp, z, prec):
    """Server rows (all of ``sp["layers"]``), mean pool, head."""
    n = next(iter(_items(sp["layers"])))[1].shape[0]
    h = z
    for l in range(n):
        h = _layer(c, _flat_layer(sp["layers"], l), h, prec)
    return mm(h.mean(1), sp["head"], prec) + sp["head_bias"]


def _tree_leaves(tree):
    return [x for _, x in _items(tree)]


def _rebuild(tree, new_leaves):
    it = iter(new_leaves)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return walk(tree)


def tpgf_step(c, cp, server, head, images, labels, d, available, tau, eps,
              prec, fault=None):
    """One local step's gradients: (g_client, g_server or None, g_head,
    l_c, l_s or None). ``cp``, ``server`` and ``head`` leaves are fp32
    tensors; ``server`` = {"layers": stacked rows [d:], "head",
    "head_bias"}. ``fault`` plants a known fault for the calibration of
    the comparison: ``"half_batch"`` (the step's second half left out),
    ``"label"`` (the first sample's label changed)."""
    if fault == "half_batch":
        images, labels = images[:len(labels) // 2], labels[:len(labels) // 2]
    elif fault == "label":
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % c["n_classes"]
    c_names = list(cp)
    c_leaves = [cp[k].detach().requires_grad_(True) for k in c_names]
    h_leaves = [head["local_head"].detach().requires_grad_(True),
                head["local_head_bias"].detach().requires_grad_(True)]
    z = _client_forward(c, dict(zip(c_names, c_leaves)), images, d, prec)
    zl = z.detach().requires_grad_(True)
    logits_c = mm(zl.mean(1), h_leaves[0], prec) + h_leaves[1]
    l_c = _xent(logits_c, labels)
    *g_head, gz_c = torch.autograd.grad(l_c, h_leaves + [zl])
    g_local = torch.autograd.grad(z, c_leaves, grad_outputs=gz_c,
                                  retain_graph=available)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in g_local))
    scale = torch.clamp(tau / (norm + 1e-12), max=1.0)
    g_local = [g * scale for g in g_local]
    if not available:
        return (dict(zip(c_names, g_local)), None,
                dict(zip(("local_head", "local_head_bias"), g_head)),
                l_c.detach(), None)
    s_leaves = [x.detach().requires_grad_(True)
                for x in _tree_leaves(server)]
    sp = _rebuild(server, s_leaves)
    l_s = _xent(_server_forward(c, sp, zl, prec), labels)
    *g_srv, gz_s = torch.autograd.grad(l_s, s_leaves + [zl])
    g_remote = torch.autograd.grad(z, c_leaves, grad_outputs=gz_s)
    w = tpgf_weight(l_c.detach(), l_s.detach(), d, c["n_layers"] - d, eps)
    g_client = [w * a + (1.0 - w) * b for a, b in zip(g_local, g_remote)]
    return (dict(zip(c_names, g_client)), _rebuild(server, g_srv),
            dict(zip(("local_head", "local_head_bias"), g_head)),
            l_c.detach(), l_s.detach())


def tpgf_weight(l_c, l_s, d, d_s, eps):
    ic, is_ = 1.0 / (l_c + eps), 1.0 / (l_s + eps)
    return d / (d + d_s) * (ic / (ic + is_))


# ----------------------------------------------------------------- rounds

class Fleet:
    """The reference's fleet, from the recorded profiles."""

    def __init__(self, c, mem_gb, lat_ms, width_tiers=None):
        cap = eq1_depths(mem_gb, lat_ms, c["n_layers"], c["alloc_alpha"],
                         c["alloc_beta"])
        self.depths = np.minimum(cap, c["n_layers"] - 1)
        self.widths = (ladder_widths(mem_gb, width_tiers)
                       if width_tiers else np.ones(len(mem_gb)))


def client_bytes(c, d: int, width: float) -> int:
    """fp32 bytes of a client's download: its slice and the local head."""
    return 4 * (vit_client_elems(c, d, width) + c["d_model"] * c["n_classes"]
                + c["n_classes"])


def run_round(c, t, params, heads, fleet: Fleet, rnd: Dict, images,
              labels, prec: str = "fp32", fault=None):
    """One round. ``params`` (global tree) and ``heads`` (stacked [N, ...])
    are fp32; ``rnd`` holds the round's draws: ``avail`` [N] bool,
    ``participants`` [N] bool, ``indices`` {client: [steps, B] flat
    sample indices}. ``images``/``labels`` are the flat dataset;
    ``prec`` and ``fault`` as in ``tpgf_step``.
    Returns (new params, new heads, {"loss", "client_losses",
    "comm_bytes"})."""
    L, lr = c["n_layers"], float(t["lr"])
    steps, eps, tau = int(t["local_steps"]), c["tpgf_eps"], c["tpgf_clip"]
    lam = c["agg_lambda"]
    step = torch.tensor(-lr, dtype=torch.float32).item()
    avail, part = rnd["avail"], rnd["participants"]
    heads = {k: v.clone() for k, v in heads.items()}
    srv_view = {"layers": params["layers"], "head": params["head"],
                "head_bias": params["head_bias"]}
    trained: Dict[int, Dict] = {}
    losses: Dict[int, float] = {}
    comm = 0
    smashed = int(t["batch_size"]) \
        * (c["image_size"] // c["patch_size"]) ** 2 * c["d_model"] * 4
    for d in sorted(set(fleet.depths.tolist())):
        ids = [i for i in range(len(fleet.depths))
               if fleet.depths[i] == d and part[i]]
        if not ids:
            continue
        base = {"layers": _rebuild(params["layers"], [
                    x[d:] for x in _tree_leaves(params["layers"])]),
                "head": params["head"], "head_bias": params["head_bias"]}
        groups: Dict[float, List[int]] = {}
        for i in ids:
            groups.setdefault(float(fleet.widths[i]), []).append(i)
        results, masses = [], []
        for w in sorted(groups):
            gids = groups[w]
            server = base
            cps = {i: client_slice(c, params, d, w) for i in gids}
            hds = {i: {k: heads[k][i] for k in heads} for i in gids}
            last = {}
            for s in range(steps):
                g_sum, n_avail = None, 0
                for i in gids:
                    rows = torch.as_tensor(rnd["indices"][i][s],
                                           device=images.device)
                    gc, gs, gh, l_c, l_s = tpgf_step(
                        c, cps[i], server, hds[i], images[rows],
                        labels[rows], d, bool(avail[i]), tau, eps, prec,
                        fault)
                    cps[i] = {k: cps[i][k] + gc[k] * step for k in cps[i]}
                    hds[i] = {k: hds[i][k] + gh[k] * step for k in hds[i]}
                    if gs is not None:
                        n_avail += 1
                        g_sum = gs if g_sum is None else _rebuild(gs, [
                            a + b for a, b in zip(_tree_leaves(g_sum),
                                                  _tree_leaves(gs))])
                    last[i] = (l_c, l_s)
                if n_avail:
                    server = _rebuild(server, [
                        x + (g / len(gids)) * step for x, g in
                        zip(_tree_leaves(server), _tree_leaves(g_sum))])
            mass = 0.0
            for i in gids:
                l_c, l_s = last[i]
                if avail[i]:
                    wc = tpgf_weight(l_c, l_s, d, L - d, eps)
                    loss = wc * l_c + (1.0 - wc) * l_s
                    mass = mass + 1.0 / (loss + eps)
                else:
                    loss = l_c
                losses[i] = loss
                trained[i] = cps[i]
                for k in heads:
                    heads[k][i] = hds[i][k]
                comm += 2 * client_bytes(c, d, w) \
                    + (steps * 2 * smashed if avail[i] else 0)
            results.append(server)
            masses.append(mass)
        if len(results) == 1:
            server = results[0]
        else:
            tot = sum(masses)
            if float(tot) > 0:
                bl = _tree_leaves(base)
                acc = [x.clone() for x in bl]
                for m, r in zip(masses, results):
                    hw = m / tot
                    acc = [a + hw * (x - b0) for a, x, b0 in
                           zip(acc, _tree_leaves(r), bl)]
                server = _rebuild(base, acc)
            else:
                server = base
        srv_view["layers"] = _rebuild(srv_view["layers"], [
            torch.cat([full[:d], new], 0) for full, new in
            zip(_tree_leaves(srv_view["layers"]),
                _tree_leaves(server["layers"]))])
        srv_view["head"] = server["head"]
        srv_view["head_bias"] = server["head_bias"]
    new = aggregate(c, params, srv_view, trained, losses, fleet, lam, eps)
    loss_vec = [float(losses[i]) for i in sorted(losses)]
    return new, heads, {"loss": float(np.mean(loss_vec)),
                        "client_losses": {i: float(losses[i])
                                          for i in losses},
                        "comm_bytes": comm}


def aggregate(c, params, srv_view, trained, losses, fleet, lam, eps):
    """Eq. 6 and 8 over the clients in ``trained`` (client -> its flat
    client dict, rows [:d_i], cut to its width)."""
    ids = sorted(trained)
    dep = {i: float(fleet.depths[i]) for i in ids}
    inv = {i: 1.0 / (float(losses[i]) + eps) for i in ids}
    D, I = sum(dep.values()), sum(inv.values())
    wt = {i: dep[i] / D * (inv[i] / I) for i in ids}
    w_tot = sum(wt.values())
    new = {k: v for k, v in params.items()}
    new["head"], new["head_bias"] = srv_view["head"], srv_view["head_bias"]
    for key in ("patch_embed", "patch_bias", "pos_embed"):
        num = sum(wt[i] * trained[i][key] for i in ids)
        new[key] = (num + lam * params[key]) / (w_tot + lam)
    out_leaves = []
    for path, s in _items(srv_view["layers"]):
        name = "layers/" + "/".join(path)
        num = torch.zeros_like(s)
        den = torch.zeros_like(s)
        for i in ids:
            x = trained[i][name]                    # [d_i, ...] cut
            region = (slice(0, x.shape[0]),) + tuple(
                slice(0, n) for n in x.shape[1:])
            num[region] += wt[i] * x
            den[region] += wt[i]
        out_leaves.append((num + lam * s) / (den + lam))
    new["layers"] = _rebuild(srv_view["layers"], out_leaves)
    return new


def change_norms(before, after, heads_before, heads_after):
    """Per-leaf norms of ``after − before``: stacked layer leaves split by
    layer row, and each client's local head leaves, one leaf each."""
    out = {}
    for path, x in leaves_of(before):
        y = get(after, path)
        if path[0] == "layers":
            for l in range(x.shape[0]):
                out["/".join(path) + f"[{l}]"] = float(
                    torch.linalg.vector_norm((y[l] - x[l]).double()))
        else:
            out["/".join(path)] = float(
                torch.linalg.vector_norm((y - x).double()))
    for k in heads_before:
        for i in range(heads_before[k].shape[0]):
            out[f"client{i}/{k}"] = float(torch.linalg.vector_norm(
                (heads_after[k][i] - heads_before[k][i]).double()))
    return out


def leaves_of(tree):
    return list(_items(tree))


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
