"""Minimal tree optimizers, the port of the JAX package's
``optim/optimizers.py``.

API mirrors optax: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``, then
``apply_updates``. The optimizers' arithmetic is fp32, except plain
``sgd``, which scales a gradient in its own dtype, as the reference's
``-lr * g`` does (a weak-typed scalar takes a bf16 gradient's dtype).

State-shape contract (the federated strategies persist the shared server
branch's moments across rounds in ``TrainState.opt_state``): an optimizer
state is either an empty tuple (stateless) or a flat dict whose entries
are

  * *moment entries* — trees mirroring the ``params`` tree exactly
    (``"mu"`` for momentum, ``"m"``/``"v"`` for AdamW), or
  * *bookkeeping entries* — scalars and counters (AdamW's int32 ``"t"``).

``map_moments`` tells the two apart structurally. The FedOpt servers
(``fedadam``, ``fedyogi``) carry two fp32 moment entries, ``"m"`` and
``"v"``, and no bookkeeping.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_structure


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def get_optimizer(name: str, lr: float, **kw) -> "Optimizer":
    """Resolve an optimizer by name. Identical (name, lr, kw) resolve to
    the SAME instance, as in the reference."""
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"available: {sorted(_OPTIMIZERS)}")
    return _cached_optimizer(name, lr, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _cached_optimizer(name: str, lr: float, kw_items: tuple) -> "Optimizer":
    return _OPTIMIZERS[name](lr, **dict(kw_items))


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def map_moments(fn: Callable[[Any], Any], state, params):
    """Apply ``fn`` to each moment entry of an optimizer ``state`` (an
    entry whose tree structure equals that of ``params``); bookkeeping
    entries and stateless ``()`` states pass through untouched."""
    if not isinstance(state, dict):
        return state
    pdef = tree_structure(params)
    return {k: fn(v) if tree_structure(v) == pdef else v
            for k, v in state.items()}


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as the configs spell it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if dtype not in names:
        raise ValueError(f"moment dtype {dtype!r}: expected one of "
                         f"{sorted(names)} or a torch dtype")
    return names[dtype]


def sgd(lr: float) -> Optimizer:
    """Plain SGD: ``p <- p - lr * g``. Stateless (state is ``()``). The
    step ``-lr`` is rounded to the gradient's dtype first, as the
    reference's weak-typed scalar is (a Python float would multiply a
    bf16 gradient at full precision)."""
    def init(params):
        return ()

    def step(g):
        # -lr rounded on the host; exact in the kernel's fp32 arithmetic
        return g * float(torch.tensor(-lr, dtype=g.dtype))

    def update(grads, state, params=None):
        return tree_map(step, grads), state

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    """Heavy-ball momentum, fp32 accumulator:

        mu <- momentum * mu + g
        p  <- p - lr * mu
    """
    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: momentum * m + g.float(),
                      state["mu"], grads)
        return tree_map(lambda m: -lr * m, mu), {"mu": mu}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=torch.float32) -> Optimizer:
    """Decoupled-weight-decay Adam (Loshchilov & Hutter):

        t <- t + 1
        m <- b1 * m + (1 - b1) * g          (stored in ``moment_dtype``)
        v <- b2 * v + (1 - b2) * g^2
        p <- p - lr * [ (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
                        + weight_decay * p ]

    ``moment_dtype`` is a torch dtype or a config's name for one
    (``cfg.adam_moment_dtype``: "float32" or "bfloat16"); the arithmetic
    is fp32 whatever the moments' or the parameters' dtype. ``t`` is an
    int32 bookkeeping counter, not a moment entry.
    """
    moment_dtype = _as_dtype(moment_dtype)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.float()
        m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g.float()
                                    ).to(moment_dtype), state["m"], grads)
        v = tree_map(lambda v_, g: (b2 * v_.float() + (1 - b2)
                                    * g.float().square()
                                    ).to(moment_dtype), state["v"], grads)
        c1 = 1.0 - torch.pow(b1, tf)
        c2 = 1.0 - torch.pow(b2, tf)

        def upd(m_, v_, p):
            step = (m_.float() / c1) / (torch.sqrt(v_.float() / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def _fedopt(lr: float, b1: float, b2: float, eps: float,
            v_rule: Callable) -> Optimizer:
    """Shared FedOpt skeleton (Reddi et al., Adaptive Federated
    Optimization — no bias correction): first moment and step are common,
    ``v_rule(v, g2)`` supplies the second-moment recursion. All fp32."""
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params=None):
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: v_rule(v_, torch.square(g.float())),
                     state["v"], grads)
        upd = tree_map(lambda m_, v_: -lr * m_ / (torch.sqrt(v_) + eps),
                       m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def fedadam(lr: float, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    """FedAdam (Reddi et al.): server-side Adam WITHOUT bias correction,

        m <- b1 * m + (1 - b1) * g
        v <- b2 * v + (1 - b2) * g^2
        p <- p - lr * m / (sqrt(v) + eps)

    ``g`` is the server pseudo-gradient (``theta_old - theta_avg``);
    ``eps`` is the paper's tau = 1e-3."""
    return _fedopt(lr, b1, b2, eps,
                   lambda v, g2: b2 * v + (1 - b2) * g2)


def fedyogi(lr: float, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    """FedYogi (Reddi et al.): FedAdam with Yogi's additive second-moment
    rule, ``v <- v - (1 - b2) * g^2 * sign(v - g^2)``."""
    return _fedopt(lr, b1, b2, eps,
                   lambda v, g2: v - (1 - b2) * g2 * torch.sign(v - g2))


_OPTIMIZERS = {"sgd": sgd, "sgd_momentum": sgd_momentum, "adamw": adamw,
               "fedadam": fedadam, "fedyogi": fedyogi}
