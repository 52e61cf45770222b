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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

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


def expert_ffn(p, x):
    """Each expert's SwiGLU on its own rows: x [E, n, dm] (or [n, dm],
    every expert on the same rows) -> [E, n, dm]."""
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(L.silu(g) * u, p["w_down"])


def _moe_tokens_dense(cfg: ModelConfig, p, xt):
    """Dense dispatch over a flat token chunk xt [T, dm] -> (y, f_e,
    P_e)."""
    E = cfg.n_experts
    probs, topv, topi = route(cfg, p, xt)
    onehot = F.one_hot(topi, E).float()                     # [T,k,E]
    combine = torch.einsum("tke,tk->te", onehot, topv)
    y_e = expert_ffn(p, xt)                                 # [E,T,dm]
    y = torch.einsum("etd,te->td", y_e, combine.to(xt.dtype))
    return (y, *_balance(onehot, probs))


def _moe_tokens_gather(cfg: ModelConfig, p, xt):
    """Capacity-based top-k gather dispatch over xt [T, dm] -> (y, f_e,
    P_e): each expert's top-``cap`` tokens by gate weight, the products
    added back with ``index_add``; a pick at gate 0 (a token the router
    did not send there) adds 0."""
    E, k = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    cap = min(max(int(cfg.moe_capacity_factor * T * k / E), 1), T)
    probs, topv, topi = route(cfg, p, xt)
    onehot = F.one_hot(topi, E).float()
    gate = torch.einsum("tke,tk->te", onehot, topv)
    gval, gidx = top_k(gate.T, cap)                         # [E,cap]
    sel = xt[gidx.reshape(-1)].reshape(E, cap, -1)
    y_e = expert_ffn(p, sel)                                # [E,cap,dm]
    w_e = torch.where(gval > 0, gval, torch.zeros_like(gval)).to(xt.dtype)
    y = torch.zeros_like(xt).index_add(
        0, gidx.reshape(-1), (y_e * w_e[..., None]).reshape(E * cap, -1))
    return (y, *_balance(onehot, probs))


def moe_apply(cfg: ModelConfig, p, x):
    """x [B, S, dm] -> (y, aux).

    Tokens go through in chunks of ``MOE_TOKEN_CHUNK`` when their count T
    is a larger multiple of it (f_e and P_e then averaged over the
    chunks), else in one pass, as the reference's scan does: the expert
    intermediate is [E, chunk, d_ff], not [E, T, d_ff]. aux is the
    Switch load-balance term E·Σ f_e·P_e / k, fp32."""
    B, S, dm = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, dm)
    c = min(MOE_TOKEN_CHUNK, T)
    fn = (_moe_tokens_gather if cfg.moe_dispatch == "gather"
          else _moe_tokens_dense)
    if T % c or T == c:
        y, f_e, P_e = fn(cfg, p, xt)
    else:
        ys, f_es, P_es = zip(*(fn(cfg, p, xk) for xk in xt.split(c)))
        y = torch.cat(ys)
        f_e = torch.stack(f_es).mean(dim=0)
        P_e = torch.stack(P_es).mean(dim=0)
    aux = E * torch.sum(f_e * P_e) / cfg.top_k
    return y.reshape(B, S, dm), aux
