"""Plain reference of the TPGF train step of a mixture-of-experts causal
LM (Mixtral's block), in PyTorch with no kernels and no code of the
measured program.

The model (arXiv:2401.04088): tokens embedded and scaled by √d_model;
per layer x + attention(RMSNorm(x)) with rotary positions (theta from
the configuration, split halves), grouped-query causal attention within
the sliding window, then x + MoE(RMSNorm(x)): a router's softmax over
the E experts, the top k renormalised to sum to 1, each picked expert's
SwiGLU (silu(x W_gate) ⊙ x W_up) W_down weighted by its share; the
Switch load-balance term E · Σ_e f_e P_e / k (f_e the share of picks,
P_e the mean probability). RMS norms store scale − 1, with the
configuration's ``rms_norm_eps``.

The split (SuperSFL at LM scale): the client holds the embedding and
layers [:d]; its local head maps every position to the vocabulary; the
server holds layers [d:], the final norm and the untied head, and its
loss adds the router coefficient times its layers' balance terms. A
step runs ``microbatches`` equal slices of the batch; on each, Eq. 3-4
as in the ViT reference (the local gradient of the client clipped to
global L2 norm tau, fused with the server's by the depth- and
loss-weighted w); the slices' gradients are averaged. Then AdamW
(bias-corrected, decoupled weight decay) with fp32 moments.

Arithmetic is fp32 from the bf16 weights (``prec`` rounds the matrix
products' operands for the lower-precision control); the parameters are
stored in the configuration's dtype, bf16, so each update is rounded
once into it.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference.precision import mm
from reference.shapes import head_dim, split_depth


def _rms(x, scale_minus_one, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale_minus_one)


def _rope(x, theta):
    """x [B, S, N, hd] rotated by position (split halves)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(c, p, x, prec):
    B, S, _ = x.shape
    hd = head_dim(c)
    q = _rope(mm(x, p["wq"], prec).reshape(B, S, -1, hd), c["rope_theta"])
    k = _rope(mm(x, p["wk"], prec).reshape(B, S, -1, hd), c["rope_theta"])
    v = mm(x, p["wv"], prec).reshape(B, S, -1, hd)
    group = q.shape[2] // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k = k.repeat_interleave(group, 1)
    v = v.repeat_interleave(group, 1)
    pos = torch.arange(S, device=x.device)
    allow = pos[None, :] <= pos[:, None]
    if c["sliding_window"]:
        allow &= pos[None, :] > pos[:, None] - c["sliding_window"]
    s = mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    s = s.masked_fill(~allow, float("-inf"))
    o = mm(torch.softmax(s, -1), v, prec).transpose(1, 2).reshape(B, S, -1)
    return mm(o, p["wo"], prec)


def _moe(c, p, x, prec):
    """-> (y, balance term); x [B, S, dm]."""
    B, S, dm = x.shape
    xt = x.reshape(-1, dm)
    E, k = c["n_experts"], c["top_k"]
    probs = torch.softmax(mm(xt, p["router"], prec), -1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(E):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xt[rows]
        g = mm(xe, p["w_gate"][e], prec)
        h = g * torch.sigmoid(g) * mm(xe, p["w_up"][e], prec)
        y = y.index_add(0, rows,
                        mm(h, p["w_down"][e], prec) * topv[rows, slot, None])
    picks = torch.nn.functional.one_hot(topi, E).float().sum(1)   # [T, E]
    aux = E * torch.sum(picks.mean(0) * probs.mean(0)) / k
    return y.reshape(B, S, dm), aux


def _layer(c, p, h, prec):
    eps = c["rms_norm_eps"]
    h = h + _attention(c, p["attn"], _rms(h, p["attn_norm_scale"], eps),
                       prec)
    y, aux = _moe(c, p["moe"], _rms(h, p["mlp_norm_scale"], eps), prec)
    return h + y, aux


def _row(tree, l):
    return {k: (_row(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _xent(logits, labels, vocab):
    logits = logits[..., :vocab]
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None].long())[..., 0]).mean()


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(pairs):
    out: Dict = {}
    for path, x in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def microbatch_grads(c, p16, tokens, labels, acc, share, prec,
                     fault=None):
    """Eq. 3-4 gradients of one microbatch, added times ``share`` into
    ``acc`` ({path: fp32 tensor}); the fp32 copies of the bf16 parameters
    ``p16`` ({path: tensor}) exist only while their side runs. Returns
    (l_c, l_s, w_client). ``fault`` plants a known fault for the
    calibration of the comparison: ``"half_batch"`` (the microbatch's
    second half of rows left out), ``"tokens"`` (its first row's input
    tokens altered)."""
    if fault == "half_batch":
        rows = max(tokens.shape[0] // 2, 1)
        tokens, labels = tokens[:rows], labels[:rows]
    elif fault == "tokens":
        tokens = tokens.clone()
        tokens[0] = (tokens[0] + 1) % c["vocab"]
    d, L = split_depth(c), c["n_layers"]
    V, dm = c["vocab"], c["d_model"]
    stacked = [k for k in p16 if k[0] == "layers"]

    def leaf(x):
        return x.float().requires_grad_(True)

    # the client: the embedding and stack rows [:d]
    cl = {k: leaf(p16[k][:d]) for k in stacked}
    emb = leaf(p16[("embed",)])
    lay = _unflatten([(k[1:], x) for k, x in cl.items()])
    h = emb[tokens.long()] * math.sqrt(dm)
    for l in range(d):
        h, _ = _layer(c, _row(lay, l), h, prec)
    z = h
    zl = z.detach().requires_grad_(True)
    head = leaf(p16[("local_head",)])
    l_c = _xent(mm(zl, head, prec), labels, V)
    g_head, gz_c = torch.autograd.grad(l_c, [head, zl])
    acc[("local_head",)].add_(g_head, alpha=share)
    del head, g_head
    # the server: stack rows [d:], the final norm, the head
    sv = {k: leaf(p16[k][d:]) for k in stacked}
    fn, unembed = leaf(p16[("final_norm", "scale")]), leaf(p16[("unembed",)])
    srv_lay = _unflatten([(k[1:], x) for k, x in sv.items()])
    h, aux = zl, 0.0
    for l in range(L - d):
        h, a = _layer(c, _row(srv_lay, l), h, prec)
        aux = aux + a
    logits = mm(_rms(h, fn, c["rms_norm_eps"]), unembed, prec)
    l_s = _xent(logits, labels, V) + c["router_aux_coef"] * aux
    del h, logits
    s_keys = list(sv) + [("final_norm", "scale"), ("unembed",)]
    *g_srv, gz_s = torch.autograd.grad(
        l_s, list(sv.values()) + [fn, unembed, zl])
    for k, g in zip(s_keys, g_srv):
        (acc[k][d:] if k in sv else acc[k]).add_(g, alpha=share)
    del sv, fn, unembed, g_srv, srv_lay
    # Eq. 3-4 on the client's two gradients
    c_keys = list(cl) + [("embed",)]
    c_in = list(cl.values()) + [emb]
    g_loc = torch.autograd.grad(z, c_in, grad_outputs=gz_c,
                                retain_graph=True)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in g_loc))
    scale = torch.clamp(c["tpgf_clip"] / (norm + 1e-12), max=1.0)
    eps = c["tpgf_eps"]
    ic, is_ = 1.0 / (l_c.detach() + eps), 1.0 / (l_s.detach() + eps)
    wc = d / L * (ic / (ic + is_))
    g_rem = torch.autograd.grad(z, c_in, grad_outputs=gz_s)
    for k, a, b in zip(c_keys, g_loc, g_rem):
        fused = wc * scale * a + (1.0 - wc) * b
        (acc[k][:d] if k in cl else acc[k]).add_(fused, alpha=share)
    return l_c.detach(), l_s.detach(), wc


class Trainer:
    """The reference's training state: bf16 parameters (the
    configuration's dtype), fp32 AdamW moments."""

    def __init__(self, c, params: Dict, opt: Dict, prec: str = "fp32",
                 fault=None):
        self.c, self.prec, self.o, self.fault = c, prec, opt, fault
        self.p = dict(_flatten(params))
        self.m = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.p.items()}
        self.t = 0

    def step(self, tokens, labels) -> Dict[str, object]:
        """One step; returns the metrics and the gradient AdamW got."""
        c, mb = self.c, max(int(self.c["microbatches"]), 1)
        acc = {k: torch.zeros_like(v, dtype=torch.float32)
               for k, v in self.p.items()}
        lc, ls, wc = [], [], []
        for tk, lb in zip(tokens.chunk(mb), labels.chunk(mb)):
            l_c, l_s, w_c = microbatch_grads(c, self.p, tk, lb, acc,
                                             1.0 / mb, self.prec, self.fault)
            lc.append(l_c), ls.append(l_s), wc.append(w_c)
        o = self.o
        self.t += 1
        c1 = 1.0 - o["b1"] ** self.t
        c2 = 1.0 - o["b2"] ** self.t
        for k, p in self.p.items():
            g = acc[k]
            self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + o["eps"]) \
                + o["weight_decay"] * p.float()
            self.p[k] = (p.float() - o["lr"] * upd).to(p.dtype)
            del upd
        return {"loss_client": torch.stack(lc).mean(),
                "loss_server": torch.stack(ls).mean(),
                "w_client": torch.stack(wc).mean(), "grads": acc}

    def params(self) -> Dict:
        return _unflatten(list(self.p.items()))


def leaf_rows(path, x) -> List:
    """A leaf split into the parts the comparison weighs apart: each layer
    row of a stacked leaf, and each expert of an expert leaf."""
    name = "/".join(path)
    if path[0] != "layers":
        return [(name, x)]
    out = []
    for l in range(x.shape[0]):
        if path[-1] in ("w_gate", "w_up", "w_down"):
            out += [(f"{name}[{l}][{e}]", x[l, e]) for e in range(x.shape[1])]
        else:
            out.append((f"{name}[{l}]", x[l]))
    return out


def norms(tree_pairs) -> Dict[str, float]:
    """Norm (fp64) of every part of every leaf of (path, tensor) pairs."""
    out = {}
    for path, x in tree_pairs:
        for name, part in leaf_rows(path, x):
            out[name] = float(torch.linalg.vector_norm(part.double()))
    return out


def flatten(tree):
    return list(_flatten(tree))
