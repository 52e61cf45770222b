"""Top-k token-choice mixture of experts (Mixtral / Grok style) with the
Switch load-balance aux loss: the JAX package's ``models/moe.py``.

Two dispatches, chosen by ``cfg.moe_dispatch`` as in the reference:
  dense  (the default) — every expert computes every token, and the
         renormalised top-k router weights mask the sum: no sort, E/k
         times the FLOPs of the routed work;
  gather — each expert takes the ``cap`` tokens with the largest gate
         weight (``cap = cf·T·k/E``, clipped to [1, T]); a token beyond
         an expert's capacity is dropped for that expert.

``top_k`` is ``jax.lax.top_k``'s: among equal values the lower index
comes first (a stable descending sort). The gather dispatch ranks every
token for every expert, most of them at gate 0, so that order decides
which tokens fill an expert's capacity.

The router's softmax, the top-k weights, ``combine`` and the balance
statistics are fp32; the expert contractions run in the activation
dtype, with ``layers.silu`` rounding each op as the reference does.

``moe_route`` and ``moe_combine`` are the ``repro_torch.trace`` spans
``moe.route`` and ``moe.experts``, in every forward run of a layer,
remat's recomputations included.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.trace import span

MOE_TOKEN_CHUNK = 4096


def moe_params(cfg: ModelConfig, gen: torch.Generator, dtype):
    """``router`` [dm, E]; ``w_gate``, ``w_up`` [E, dm, dff] and
    ``w_down`` [E, dff, dm] (scale 0.02/√(2L)), drawn from ``gen``."""
    dm, dff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    down_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "router": L.dense_init(gen, dm, E, dtype),
        "w_gate": L.normal(gen, (E, dm, dff), dtype),
        "w_up": L.normal(gen, (E, dm, dff), dtype),
        "w_down": L.normal(gen, (E, dff, dm), dtype, down_scale),
    }


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, the lower index first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(cfg: ModelConfig, p, xt):
    """The router on a flat token chunk ``xt`` [T, dm] -> (probs [T, E]
    fp32, the renormalised top-k weights [T, k], their experts [T, k])."""
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, cfg.top_k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    return probs, topv, topi


def _balance(onehot, probs):
    """(f_e, P_e): the share of top-k picks and the mean probability of
    each expert over the chunk."""
    return onehot.sum(dim=1).mean(dim=0), probs.mean(dim=0)


def _bmm_f32(a, b):
    """``torch.bmm(a, b)`` with an fp32 result: cuBLAS hands out its fp32
    accumulator for bf16 operands (``out_dtype``); the CPU has no such
    kernel, so there the operands are widened first (exactly, for bf16)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


class _SharedRowsGateUp(torch.autograd.Function):
    """(x @ w_gate[e], x @ w_up[e]) for every expert e on the same rows
    x [n, dm] -> two [E, n, dff].

    Batched GEMMs over x broadcast along the expert axis (batch stride 0)
    read the weights as stored. ``torch.matmul(x, w)`` with a gradient
    folds ``w`` into ``w.mT.reshape(E·dff, dm)`` instead, a transposed
    copy of each weight a call, and copies the [E, n, dff] output
    gradient and the weight gradient in its backward. The weight
    gradients are the same K = n contractions here; the input gradient
    sums the 2·E per-expert products in fp32 and rounds once (the folded
    GEMMs round each weight's sum, and autograd their sum)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        xe = x.expand(w_gate.shape[0], *x.shape)
        return torch.bmm(xe, w_gate), torch.bmm(xe, w_up)

    @staticmethod
    def backward(ctx, dg, du):
        x, w_gate, w_up = ctx.saved_tensors
        dx = dwg = dwu = None
        if ctx.needs_input_grad[0]:
            acc = _bmm_f32(dg, w_gate.mT)
            acc += _bmm_f32(du, w_up.mT)
            dx = acc.sum(dim=0).to(x.dtype)
        xte = x.mT.expand(w_gate.shape[0], *x.mT.shape)      # [E,dm,n]
        if ctx.needs_input_grad[1]:
            dwg = torch.bmm(xte, dg)
        if ctx.needs_input_grad[2]:
            dwu = torch.bmm(xte, du)
        return dx, dwg, dwu


def gate_up(p, x):
    """The experts' gate and up products, each [E, n, dff]: x [E, n, dm]
    (each expert on its own rows, the gather dispatch) through
    ``torch.matmul``, or x [n, dm] (every expert on the same rows, the
    dense dispatch) through ``_SharedRowsGateUp``."""
    if x.dim() == 2:
        return _SharedRowsGateUp.apply(x, p["w_gate"], p["w_up"])
    return torch.matmul(x, p["w_gate"]), torch.matmul(x, p["w_up"])


def expert_ffn(p, x):
    """Each expert's SwiGLU on its own rows: x [E, n, dm] (or [n, dm],
    every expert on the same rows) -> [E, n, dm]."""
    g, u = gate_up(p, x)
    return torch.matmul(L.silu(g) * u, p["w_down"])


def _route_dense(cfg: ModelConfig, p, xt):
    """The dense dispatch's routing of a flat token chunk xt [T, dm]:
    (combine [T, E] fp32, f_e, P_e)."""
    probs, topv, topi = route(cfg, p, xt)
    onehot = F.one_hot(topi, cfg.n_experts).float()          # [T,k,E]
    combine = torch.einsum("tke,tk->te", onehot, topv)
    return combine, *_balance(onehot, probs)


def _combine_dense(p, xt, combine):
    """Every expert on every token of xt, the products masked and summed
    by ``combine`` [T, E]."""
    y_e = expert_ffn(p, xt)                                 # [E,T,dm]
    return torch.einsum("etd,te->td", y_e, combine.to(xt.dtype))


def _route_gather(cfg: ModelConfig, p, xt):
    """The gather dispatch's routing of xt [T, dm]: each expert's
    top-``cap`` tokens by gate weight, (gate values [E, cap] fp32, their
    token indices [E, cap]), f_e, P_e."""
    E, k = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    cap = min(max(int(cfg.moe_capacity_factor * T * k / E), 1), T)
    probs, topv, topi = route(cfg, p, xt)
    onehot = F.one_hot(topi, E).float()
    gate = torch.einsum("tke,tk->te", onehot, topv)
    gval, gidx = top_k(gate.T, cap)                         # [E,cap]
    return torch.stack([gval, gidx.to(gval.dtype)]), *_balance(onehot,
                                                               probs)


def _combine_gather(p, xt, routed):
    """Each expert on its picked tokens, the products added back with
    ``index_add``; a pick at gate 0 (a token the router did not send
    there) adds 0."""
    gval, gidx = routed[0], routed[1].long()
    E, cap = gval.shape
    sel = xt[gidx.reshape(-1)].reshape(E, cap, -1)
    y_e = expert_ffn(p, sel)                                # [E,cap,dm]
    w_e = torch.where(gval > 0, gval, torch.zeros_like(gval)).to(xt.dtype)
    return torch.zeros_like(xt).index_add(
        0, gidx.reshape(-1), (y_e * w_e[..., None]).reshape(E * cap, -1))


def _chunks(xt):
    """xt [T, dm] in chunks of ``MOE_TOKEN_CHUNK`` when T is a larger
    multiple of it, else whole, as the reference's scan takes them."""
    c = min(MOE_TOKEN_CHUNK, xt.shape[0])
    if xt.shape[0] % c or xt.shape[0] == c:
        return [xt]
    return list(xt.split(c))


def moe_route(cfg: ModelConfig, p, xt):
    """The router over the flat tokens xt [T, dm], chunk by chunk: (each
    chunk's routing stacked on a leading axis, f_e, P_e); f_e and P_e are
    averaged over the chunks."""
    fn = _route_gather if cfg.moe_dispatch == "gather" else _route_dense
    with span("moe.route"):
        parts = [fn(cfg, p, xk) for xk in _chunks(xt)]
        if len(parts) == 1:
            routed, f_e, P_e = parts[0]
            return routed[None], f_e, P_e
        routed, f_es, P_es = zip(*parts)
        return (torch.stack(routed), torch.stack(f_es).mean(dim=0),
                torch.stack(P_es).mean(dim=0))


def moe_combine(cfg: ModelConfig, p, xt, routed):
    """The experts over xt [T, dm] by ``moe_route``'s routing -> y [T,
    dm]. Linear in the expert weights' d_ff slices: a tensor-parallel
    rank's d_ff slice gives its share of the sum."""
    fn = _combine_gather if cfg.moe_dispatch == "gather" else _combine_dense
    with span("moe.experts"):
        ys = [fn(p, xk, r) for xk, r in zip(_chunks(xt), routed)]
        return ys[0] if len(ys) == 1 else torch.cat(ys)


def moe_aux(cfg: ModelConfig, f_e, P_e):
    """The Switch load-balance term E·Σ f_e·P_e / k, fp32."""
    return cfg.n_experts * torch.sum(f_e * P_e) / cfg.top_k


def moe_apply(cfg: ModelConfig, p, x):
    """x [B, S, dm] -> (y, aux).

    Tokens go through in chunks of ``MOE_TOKEN_CHUNK`` when their count T
    is a larger multiple of it (f_e and P_e then averaged over the
    chunks), else in one pass, as the reference's scan does: the expert
    intermediate is [E, chunk, d_ff], not [E, T, d_ff]. aux is the
    Switch load-balance term, fp32."""
    B, S, dm = x.shape
    xt = x.reshape(B * S, dm)
    routed, f_e, P_e = moe_route(cfg, p, xt)
    y = moe_combine(cfg, p, xt, routed)
    return y.reshape(B, S, dm), moe_aux(cfg, f_e, P_e)
