"""The plain reference's TPGF train step of a causal LM computed in
blocks, so that it fits on one card beside its own training state at
long sequences; the model's equations come from a ``Family``.

The step is ``reference/lm_tpgf.py``'s: the client holds the embedding
and layers [:d] and its untied local head; the server holds layers [d:],
the final norm and its untied head, and its loss adds the router
coefficient times its layers' balance terms; on each of ``microbatches``
slices, Eq. 3-4 (the client's local gradient clipped to global L2 norm
tau, fused with the server's by the depth- and loss-weighted w); the
slices' gradients averaged; then AdamW (bias-corrected, decoupled weight
decay) with fp32 moments, each update rounded once into the stored
dtype.

In blocks: each side's forward runs without a graph, keeping each
layer's input; the backward then runs layer by layer from the last, each
layer recomputed on fp32 copies of its own parameters alone. The
client's local gradient is kept whole until its norm is known; its
remote gradient is added as each layer yields it. Arithmetic is fp32
from the stored weights (``prec`` rounds the matrix products' operands
for the lower-precision control).

Planted faults, for the calibration of the comparison: ``"tokens"``
(each microbatch's first row's input tokens altered) and
``"half_batch"`` (the step's second half of microbatches left out, the
rest keeping their share: a program that runs two of four).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch

from reference import lm_tpgf
from reference.lm_tpgf import _flatten, _unflatten
from reference.precision import mm
from reference.shapes import split_depth


class Family(NamedTuple):
    """What a model family puts into the step: the factor on the
    embedding rows, the divisor of both heads' logits, and
    ``layer(c, p16, l)`` -> (forward(p, h, prec) -> (h, balance term),
    {path inside the layer: (path in the tree, row)})."""
    embed_scale: Callable[[Dict], float]
    logit_div: Callable[[Dict], float]
    layer: Callable


def _mixtral_layer(c, p16, l):
    where = {path[1:]: (path, l) for path in p16 if path[0] == "layers"}
    return (lambda p, h, prec: lm_tpgf._layer(c, p, h, prec)), where


# Mixtral's block (``reference/lm_tpgf.py``): embedding times √d_model,
# every layer of one kind, unscaled logits
MIXTRAL = Family(lambda c: math.sqrt(c["d_model"]), lambda c: 1.0,
                 _mixtral_layer)


def _layer_params(p16, where, grad):
    leaves = {q: p16[path][row].float().requires_grad_(grad)
              for q, (path, row) in where.items()}
    return leaves, _unflatten(leaves.items())


@torch.no_grad()
def _forward(fam, c, p16, h, layers, prec):
    """Layers ``layers`` over h, no graph: (each layer's input and the
    last output, the sum of their balance terms)."""
    hs, aux = [h], 0.0
    for l in layers:
        fwd, where = fam.layer(c, p16, l)
        h, a = fwd(_layer_params(p16, where, False)[1], h, prec)
        hs.append(h)
        aux = aux + a
    return hs, aux


def _layer_vjp(fam, c, p16, l, h_in, g_out, aux_coef, prec):
    """Layer ``l`` recomputed on fp32 copies of its parameters: ({(path,
    row): gradient}, the gradient of its input) for the cotangent g_out
    of its output plus ``aux_coef`` times its balance term."""
    fwd, where = fam.layer(c, p16, l)
    leaves, tree = _layer_params(p16, where, True)
    h = h_in.detach().requires_grad_(True)
    out, aux = fwd(tree, h, prec)
    outs, cots = [out], [g_out]
    if aux_coef:
        outs.append(aux)
        cots.append(torch.tensor(aux_coef, device=h.device))
    gs = torch.autograd.grad(outs, list(leaves.values()) + [h], cots)
    return {where[q]: g for q, g in zip(leaves, gs[:-1])}, gs[-1]


def _xent(logits, labels, vocab):
    logits = logits[..., :vocab]
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None].long())[..., 0]).mean()


def microbatch_grads(fam: Family, c, p16, tokens, labels, acc, share, prec,
                     fault=None):
    """Eq. 3-4 gradients of one microbatch, added times ``share`` into
    ``acc`` ({path: fp32 tensor}); ``p16`` holds the stored parameters
    ({path: tensor}). Returns (l_c, l_s, w_client)."""
    if fault == "tokens":
        tokens = tokens.clone()
        tokens[0] = (tokens[0] + 1) % c["vocab"]
    d, L, V, dm = split_depth(c), c["n_layers"], c["vocab"], c["d_model"]
    eps, div = c["rms_norm_eps"], fam.logit_div(c)
    mult, coef = fam.embed_scale(c), c["router_aux_coef"]
    tok = tokens.long()

    def add(grads, scale=1.0):
        for (path, row), g in grads.items():
            (acc[path] if row is None else acc[path][row]).add_(
                g, alpha=share * scale)

    # the client's forward, then the local head (Phase 1)
    hs, _ = _forward(fam, c, p16, p16[("embed",)][tok].float() * mult,
                     range(d), prec)
    z = hs.pop()
    zl = z.clone().requires_grad_(True)
    head = p16[("local_head",)].float().requires_grad_(True)
    l_c = _xent(mm(zl, head, prec) / div, labels, V)
    g_head, gz_c = torch.autograd.grad(l_c, [head, zl])
    add({(("local_head",), None): g_head})
    del head, g_head, zl
    # the server: its forward, its loss, its backward layer by layer
    hs_s, aux = _forward(fam, c, p16, z, range(d, L), prec)
    hl = hs_s.pop().requires_grad_(True)
    fn = p16[("final_norm", "scale")].float().requires_grad_(True)
    un = p16[("unembed",)].float().requires_grad_(True)
    xent = _xent(mm(lm_tpgf._rms(hl, fn, eps), un, prec) / div, labels, V)
    l_s = xent.detach() + coef * aux
    g_fn, g_un, g = torch.autograd.grad(xent, [fn, un, hl])
    add({(("final_norm", "scale"), None): g_fn, (("unembed",), None): g_un})
    del fn, un, g_fn, g_un, hl
    for l in reversed(range(d, L)):
        grads, g = _layer_vjp(fam, c, p16, l, hs_s.pop(), g, coef, prec)
        add(grads)
        del grads
    gz_s = g

    # the client's two pulls, each through its layers and the embedding
    def pull(g, sink):
        for l in reversed(range(d)):
            grads, g = _layer_vjp(fam, c, p16, l, hs[l], g, 0.0, prec)
            sink(grads)
            del grads
        sink({(("embed",), None): torch.zeros(
            p16[("embed",)].shape, device=g.device).index_add_(
                0, tok.reshape(-1), (g * mult).reshape(-1, dm))})

    g_loc = {}
    pull(gz_c, g_loc.update)
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g_loc.values()))
    scale = torch.clamp(c["tpgf_clip"] / (norm + 1e-12), max=1.0)
    ic, is_ = 1.0 / (l_c.detach() + c["tpgf_eps"]), 1.0 / (l_s + c["tpgf_eps"])
    wc = d / L * (ic / (ic + is_))
    add({k: wc * scale * x for k, x in g_loc.items()})
    del g_loc
    pull(gz_s, lambda grads: add({k: (1.0 - wc) * x
                                  for k, x in grads.items()}))
    return l_c.detach(), l_s, wc


class Trainer:
    """The reference's training state: the stored parameters (the
    configuration's dtype), fp32 AdamW moments; one step runs
    ``microbatch_grads`` over the configuration's microbatches."""

    def __init__(self, fam: Family, c, params: Dict, opt: Dict,
                 prec: str = "fp32", fault=None):
        self.fam, self.c, self.prec, self.o = fam, c, prec, opt
        self.fault = fault
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
        slices = list(zip(tokens.chunk(mb), labels.chunk(mb)))
        if self.fault == "half_batch":
            slices = slices[:max(len(slices) // 2, 1)]
        lc, ls, wc = [], [], []
        for tk, lb in slices:
            l_c, l_s, w_c = microbatch_grads(self.fam, c, self.p, tk, lb,
                                             acc, 1.0 / mb, self.prec,
                                             self.fault)
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
