"""Plain reference of the TPGF train step of the ssm_moe family
(Granite-4.0-H-Small's block), in PyTorch with no kernels and no code of
the measured program.

The model (ibm-granite/granite-4.0-h-small, config.json, and the
source's GraniteMoeHybrid modelling): tokens embedded and multiplied by
``embedding_multiplier``; per layer, in the order ``layer_kinds`` gives,

    h ← h + r · mixer(RMSNorm(h))
    h ← h + r · (MoE(x) + shared(x)),   x = RMSNorm(h)

with r the ``residual_multiplier``. The mixer is either

* Mamba-2 (arXiv:2405.21060, one group): [z, xBC, dt] = x W_in;
  xBC ← silu(depthwise causal conv(xBC) + b) over x, B and C together;
  [x, B, C] = xBC; dt ← softplus(dt + dt_bias); A = −exp(A_log); per
  head the state h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t ⊗ B_t and
  y_t = h_t·C_t + D·x_t, computed in its chunked (SSD) form in blocks
  of ``CHUNK`` rows with the state carried between them;
  y ← RMSNorm(y ⊙ silu(z)) over d_inner; out = y W_out; or
* causal grouped-query attention with no position embedding, the
  scores multiplied by ``attention_multiplier``, in blocks of ``QBLOCK``
  queries.

The MoE: the router's logits x W_r over all ``router_experts``; the top
k logits; the gates their softmax; each expert held here
(``[expert_offset, expert_offset + n_experts)``) computes the SwiGLU
silu(x W_gate) ⊙ (x W_up) W_down of its tokens, weighted by their gate;
the shared SwiGLU runs on every token. The last norm, the head, and the
logits divided by ``logits_scaling``. RMS norms store scale − 1, with
eps ``rms_norm_eps``.

Departures from the source, each the measured program's too: the
client's untied local head and the server's untied head (SuperSFL puts
the embedding on the client; the source ties the head to it); the
balance term, the port's E·Σ_e f_e·P_e / k per layer over the router's
E outputs (f_e the share of picks, P_e the mean probability), summed
over the server's layers, where the source's takes every layer's router
outputs at once and does not divide by k; the experts held, a card's
share under expert parallelism, as the configuration states.

The split (SuperSFL at LM scale), Eq. 3-4 on each of ``microbatches``
slices and AdamW are those of ``reference/lm_tpgf.py``, computed in
blocks by ``reference/tpgf_blocked.py`` (``GRANITE``), with the
embedding times ``embedding_multiplier`` and both heads' logits divided
by ``logits_scaling``. Arithmetic is fp32 from the bf16 weights
(``prec`` rounds the matrix products' operands for the lower-precision
control); each update is rounded once into bf16.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.lm_tpgf import _flatten
from reference.precision import mm
from reference.shapes import head_dim
from reference.tpgf_blocked import Family
from reference.ssm_moe_shapes import KINDS, kind_rows, ssm_dims

CHUNK = 512
QBLOCK = 1024


def _rms(x, scale_minus_one, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale_minus_one)


def _silu(x):
    return x * torch.sigmoid(x)


def _ssd(x, dt, A, B, C, prec):
    """y [Bt, S, nh, hd] of the scan (without D·x) from x [Bt, S, nh, hd],
    dt [Bt, S, nh], A [nh], B, C [Bt, S, st]."""
    Bt, S, nh, hd = x.shape
    h = x.new_zeros(Bt, nh, hd, B.shape[-1])
    ys = []
    for c0 in range(0, S, CHUNK):
        xs, dts = x[:, c0:c0 + CHUNK], dt[:, c0:c0 + CHUNK]
        Bs, Cs = B[:, c0:c0 + CHUNK], C[:, c0:c0 + CHUNK]
        Q = xs.shape[1]
        a = torch.cumsum(dts * A, 1)                          # [Bt, Q, nh]
        below = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        seg = (a[:, :, None] - a[:, None]).masked_fill(
            ~below[None, :, :, None], -math.inf)              # [Bt, i, j, nh]
        u = xs * dts[..., None]                               # [Bt, Q, nh, hd]
        W = mm(Cs, Bs.transpose(1, 2), prec)[..., None] * torch.exp(seg)
        y = mm(W.permute(0, 3, 1, 2), u.transpose(1, 2), prec)  # [Bt,nh,Q,hd]
        y = y + torch.exp(a).transpose(1, 2)[..., None] * mm(
            Cs[:, None], h.transpose(-1, -2), prec)
        ys.append(y.transpose(1, 2))
        rest = torch.exp(a[:, -1:] - a)                       # [Bt, Q, nh]
        h = torch.exp(a[:, -1])[..., None, None] * h + mm(
            (u * rest[..., None]).permute(0, 2, 3, 1), Bs[:, None], prec)
    return torch.cat(ys, 1)


def _mamba(c, p, x, prec):
    s = ssm_dims(c)
    din, st, nh, hd = s["din"], s["st"], s["nh"], s["hd"]
    Bt, S, _ = x.shape
    z, xbc, dt = mm(x, p["w_in"], prec).split([din, din + 2 * st, nh], -1)
    xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :],
                   p["conv_b"], padding=s["k"] - 1,
                   groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xs, B, C = _silu(xbc).split([din, st, st], -1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bt, S, nh, hd)
    y = _ssd(xh, dt, A, B, C, prec) + xh * p["D"][:, None]
    y = _rms(y.reshape(Bt, S, din) * _silu(z), p["gate_norm_scale"],
             c["rms_norm_eps"])
    return mm(y, p["w_out"], prec)


def _attention(c, p, x, prec):
    Bt, S, _ = x.shape
    hd = head_dim(c)
    q = mm(x, p["wq"], prec).reshape(Bt, S, -1, hd).transpose(1, 2)
    k = mm(x, p["wk"], prec).reshape(Bt, S, -1, hd).transpose(1, 2)
    v = mm(x, p["wv"], prec).reshape(Bt, S, -1, hd).transpose(1, 2)
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    pos = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, QBLOCK):
        s = mm(q[:, :, q0:q0 + QBLOCK], k.transpose(-1, -2), prec) \
            * c["attention_multiplier"]
        later = pos[None, :] > pos[q0:q0 + QBLOCK, None]
        outs.append(mm(torch.softmax(s.masked_fill(later, -math.inf), -1),
                       v, prec))
    o = torch.cat(outs, 2).transpose(1, 2).reshape(Bt, S, -1)
    return mm(o, p["wo"], prec)


def _swiglu(p, x, prec, e=None):
    w = (lambda n: p[n]) if e is None else (lambda n: p[n][e])
    return mm(_silu(mm(x, w("w_gate"), prec)) * mm(x, w("w_up"), prec),
              w("w_down"), prec)


def _moe(c, p, x, prec):
    """-> (the held experts' part plus the shared expert, balance term)."""
    B, S, dm = x.shape
    xt = x.reshape(-1, dm)
    R, k, off = c["router_experts"], c["top_k"], c["expert_offset"]
    logits = mm(xt, p["router"], prec)
    top, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, topi = top[:, :k], topi[:, :k]
    gates = torch.softmax(top, -1)
    y = _swiglu(p["shared"], xt, prec)
    for e in range(c["n_experts"]):
        rows, slot = torch.nonzero(topi == off + e, as_tuple=True)
        if rows.numel():
            y = y.index_add(0, rows, _swiglu(p, xt[rows], prec, e)
                            * gates[rows, slot, None])
    picks = F.one_hot(topi, R).float().sum(1)                # [T, R]
    probs = torch.softmax(logits, -1)
    aux = R * torch.sum(picks.mean(0) * probs.mean(0)) / k
    return y.reshape(B, S, dm), aux


def layer_forward(c, kind, p, h, prec):
    """One layer: (h out, its balance term). ``p`` holds the layer's rows
    and its mixer under ``mixer``."""
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    x = _rms(h, p["mixer_norm_scale"], eps)
    mix = _mamba if kind == "mamba" else _attention
    h = h + r * mix(c, p["mixer"], x, prec)
    y, aux = _moe(c, p["moe"], _rms(h, p["ffn_norm_scale"], eps), prec)
    return h + r * y, aux


def layer_rows(c, p16, l):
    """Layer ``l``'s kind and {path inside the layer: (path in the tree,
    row)}: the rows of the per-layer leaves and of its kind's stack."""
    kind = c["layer_kinds"][l]
    j = kind_rows(c, kind, 0, l)
    where = {}
    for path in p16:
        if path[0] != "layers":
            continue
        if path[1] not in KINDS:
            where[path[1:]] = (path, l)
        elif path[1] == kind:
            where[("mixer",) + path[2:]] = (path, j)
    return kind, where


def _granite_layer(c, p16, l):
    kind, where = layer_rows(c, p16, l)
    return (lambda p, h, prec: layer_forward(c, kind, p, h, prec)), where


# the family's part of the blocked step (``reference/tpgf_blocked.py``)
GRANITE = Family(lambda c: c["embedding_multiplier"],
                 lambda c: c["logits_scaling"], _granite_layer)


def leaf_rows(path, x):
    """A leaf split into the parts the comparison weighs apart: each row
    of a stacked leaf (a layer, or a layer of the mixer's kind), and each
    expert of a routed expert's leaf."""
    name = "/".join(path)
    if path[0] != "layers":
        return [(name, x)]
    out = []
    for l in range(x.shape[0]):
        if path[-2] == "moe" and path[-1] in ("w_gate", "w_up", "w_down"):
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
