"""Classic FedAvg as an engine strategy: the full model trained locally,
a data-size-weighted full-model average. No split, no server compute.

The FedOpt family (Reddi et al., Adaptive Federated Optimization) rides
on the same fold: the round's weighted average is taken as a
pseudo-gradient ``theta_old - theta_avg`` and folded through a *server*
optimizer whose state persists across rounds (and checkpoints) in
``TrainState.opt_state["server"]``. ``fedavgm`` is the heavy-ball member
(Hsu et al.); ``fedadam`` and ``fedyogi`` are the adaptive members
(``repro_torch.optim.fedadam``/``fedyogi``: no bias correction,
tau = 1e-3).

A cohort's local steps are a plain loop over steps and clients; each
client trains its own copy of the full model with an optimizer state made
fresh each round. The average is a plain torch reduction: the reference
has no kernel for it.

On a fleet mesh each rank trains the clients of the cohort that it owns;
the size-weighted average is each rank's ``einsum`` over its own models,
all-reduced once with the cohort's loss vector (whose mean is the
round's loss), and the server fold runs replicated.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.federated import metrics as MET
from repro_torch.federated.strategies import base
from repro_torch.federated.strategies.base import (CohortResult, RoundContext,
                                                   Strategy, register_strategy)
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim import (Optimizer, apply_updates, fedadam, fedyogi,
                               sgd_momentum)
from repro_torch.tree import grad_leaves, tree_map, tree_unflatten


def _full_grads(cfg, params, batch):
    """(loss, grads) of ``full_loss``; leaves the loss does not reach (the
    local head) get zero gradients."""
    paths, leaves = grad_leaves(params)
    loss = M.full_loss(cfg, tree_unflatten(paths, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(paths, grads)


@register_strategy("fedavg")
class FedAvg(Strategy):
    """``server_momentum=0`` without ``server_opt`` is exact FedAvg: the
    server fold is skipped, not applied with a unit step, and no server
    slot is created. ``fedavgm`` registers heavy-ball momentum at 0.9;
    ``fedadam``/``fedyogi`` the adaptive members. Any
    ``repro_torch.optim.Optimizer`` may be passed as ``server_opt``: it
    gets the pseudo-gradient ``theta_old - theta_avg`` once a round."""

    kernel_name = "step_kernel"

    def __init__(self, server_momentum: float = 0.0,
                 server_opt: Optimizer = None):
        if server_momentum and server_opt is not None:
            raise ValueError(
                "pass either server_momentum or an explicit server_opt")
        self.server_momentum = server_momentum
        # pseudo-gradient step: mu <- beta*mu + (old - avg); p <- p - mu
        self._server_opt = server_opt if server_opt is not None else (
            sgd_momentum(1.0, server_momentum) if server_momentum else None)

    def prepare_fleet(self, cfg, fleet, device_model=None) -> None:
        fleet.depths[:] = cfg.split_stack_len   # the full model, locally

    def cohorts(self, engine, ctx: RoundContext):
        """One cohort of every available sampled client; if nobody is
        reachable the round falls back to every participant."""
        ids = np.where(ctx.avail & ctx.participants)[0]
        if len(ids) == 0:
            ids = np.where(ctx.participants)[0]
        if len(ids) == 0:   # an arrival process may leave nobody at all
            return {}
        return {engine.cfg.split_stack_len: ids}

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        return {"ids": None, "models": None, "losses": None}

    def cohort_step(self, engine, ctx, ws, d, ids) -> CohortResult:
        cfg, state, opt = engine.cfg, engine.state, engine.optimizer
        dev = engine.device
        idx = torch.as_tensor(
            ctx.sample_indices(ids, engine.local_steps,
                               engine.batch_size).astype(np.int64),
            device=dev)
        dd = engine.device_data
        mine = np.where(engine.owned(ids))[0]   # the cohort positions here
        m = len(mine)
        # the optimizers and apply_updates build new tensors, so every
        # copy may start as a reference to the global tree
        models = [state.params] * m
        states = [opt.init(state.params) for _ in range(m)]
        losses = [None] * m
        for t in range(engine.local_steps):
            for j, i in enumerate(mine):
                rows = idx[t, i]
                batch = {"images": dd.images[rows], "label": dd.labels[rows]}
                losses[j], g = _full_grads(cfg, models[j], batch)
                upd, states[j] = opt.update(g, states[j], models[j])
                models[j] = apply_updates(models[j], upd)
        ws["ids"], ws["models"], ws["mine"] = np.asarray(ids), models, mine
        ws["losses"] = (torch.stack(losses).to(torch.float32) if m else
                        torch.zeros(0, dtype=torch.float32, device=dev))
        nparams = M.param_count(state.params)
        return CohortResult(nparams, 0, losses=ws["losses"])

    def slot_outputs(self, engine, ws, ids, res):
        # each client's trained full model, stacked along the cohort axis
        if not ws["models"]:
            return {"losses": res.losses}
        return {"losses": res.losses,
                "model": tree_map(lambda *xs: torch.stack(xs),
                                  *ws["models"])}

    def aggregate(self, engine, ws):
        """The size-weighted average: this rank's fp32 ``einsum`` over its
        own models and its rows of the cohort's loss vector, summed over
        the ranks of a fleet mesh in one all-reduce."""
        ids, mine = ws["ids"], ws["mine"]
        if ids is None:   # nobody arrived this round
            return engine.state.params, float("nan")
        params, dev = engine.state.params, engine.device
        sizes = np.array([len(engine.data["clients"][i].labels)
                          for i in ids], np.float32)
        w = torch.as_tensor(sizes / sizes.sum(), device=dev)
        pos = torch.as_tensor(mine, device=dev)
        if len(mine):
            part = tree_map(lambda *xs: torch.einsum(
                "n,n...->...", w[pos], torch.stack([x.float() for x in xs])),
                *ws["models"])
        else:
            part = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                            params)
        losses = torch.zeros(len(ids), dtype=torch.float32, device=dev)
        losses[pos] = ws["losses"]
        total, losses = SH.fleet_sum_tree((part, losses), engine.mesh)
        avg = tree_map(lambda t, x: t.to(x.dtype), total, params)
        loss = float(losses.mean())
        if self._server_opt is None:
            return avg, loss
        return self._server_fold(engine, avg), loss

    def _server_fold(self, engine, avg):
        """FedOpt: fold the round average through the persistent server
        optimizer (heavy-ball, Adam or Yogi), re-initialized when absent or
        of another shape (``base.valid_opt_state``)."""
        params = engine.state.params
        cur = base.valid_opt_state(engine, self._server_opt, params)
        delta = tree_map(lambda old, new: old.float() - new.float(),
                         params, avg)
        updates, cur = self._server_opt.update(delta, cur, params)
        engine.state.opt_state["server"] = cur
        return apply_updates(params, updates)

    def comm_cost(self, engine, d, available, ids=None):
        return 2 * MET.tree_bytes(engine.state.params), 2


@register_strategy("fedavgm")
class FedAvgM(FedAvg):
    """FedAvg + 0.9 server momentum (Hsu et al., 2019)."""

    def __init__(self, server_momentum: float = 0.9):
        super().__init__(server_momentum=server_momentum)


@register_strategy("fedadam")
class FedAdam(FedAvg):
    """FedAvg + server-side Adam on the round's pseudo-gradient (Reddi et
    al., 2021); ``server_lr`` is eta_s, and tau = 1e-3 bounds the
    adaptivity."""

    def __init__(self, server_lr: float = 0.1, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-3):
        super().__init__(server_opt=fedadam(server_lr, b1=b1, b2=b2,
                                            eps=eps))


@register_strategy("fedyogi")
class FedYogi(FedAvg):
    """FedAvg + server-side Yogi (Reddi et al., 2021): Adam's first
    moment, Yogi's additive second-moment rule."""

    def __init__(self, server_lr: float = 0.1, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-3):
        super().__init__(server_opt=fedyogi(server_lr, b1=b1, b2=b2,
                                            eps=eps))
