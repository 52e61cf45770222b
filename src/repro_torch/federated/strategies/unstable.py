"""Unstable client participation (Wei et al.) as an engine strategy.

SuperSFL's round under an arrival process: clients flap on and off
following a per-client Markov (Gilbert) chain — long correlated outages
rather than i.i.d. dropouts — plus a per-round deadline-straggler draw
(``core.fault.MarkovArrivalProcess``, supplied through the
``participation_process`` hook and owned by the engine).

Staleness-weighted aggregation: a client rejoining after ``s`` missed
rounds trained this round from the current globals, but its fault-tolerant
head phi_i (and so its loss) reflects a trajectory ``s`` rounds behind the
fleet. Its Eq. 6 weight is discounted by ``(1 + s)^-gamma`` (Xie et al.,
FedAsync) and the weights renormalized to sum to 1; ``gamma=0`` is plain
SuperSFL weighting.

Departure from the reference, (a) extended: ``aggregate`` passes
``cfg.use_pallas`` and the fleet's ``widths`` to
``core.aggregation.aggregate_weighted``, so the split stack's Eq. 8 runs
through the hand-written ``aggregate`` kernel, as ``ssfl``'s does (the
reference's call passes neither). At full width the widths change
nothing.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core.fault import ArrivalProcess, MarkovArrivalProcess
from repro_torch.federated.strategies.base import (RoundContext,
                                                   register_strategy)
from repro_torch.federated.strategies.ssfl import SuperSFL


def staleness_weights(w, staleness, gamma: float = 1.0,
                      mask=None) -> np.ndarray:
    """Discount per-client weights by ``(1 + s)^-gamma`` and renormalize
    to sum to 1 (float64, host). ``mask`` marks the clients that trained
    (weight 0 elsewhere); all-zero weights fall back to uniform over the
    mask."""
    w = np.asarray(w, np.float64)
    s = np.asarray(staleness, np.float64)
    assert w.shape == s.shape
    if mask is not None:
        w = np.where(mask, w, 0.0)
    w = w * (1.0 + s) ** (-gamma)
    total = w.sum()
    if total <= 0.0:
        if mask is None:
            return np.full_like(w, 1.0 / len(w))
        m = np.asarray(mask, np.float64)
        return m / m.sum()
    return w / total


def discounted_weights(engine, depths, losses, staleness, gamma: float,
                       mask) -> torch.Tensor:
    """Eq. 6 weights of the ``mask``ed clients, discounted by staleness:
    fp32 on the engine's device, for ``aggregate_weighted``."""
    w = AGG.client_weights(depths, losses, engine.cfg.tpgf_eps, mask=mask)
    w = staleness_weights(w.cpu().numpy(), staleness, gamma, mask=mask)
    return torch.as_tensor(np.asarray(w, np.float32), device=engine.device)


@register_strategy("unstable")
class UnstableParticipation(SuperSFL):
    """SuperSFL under Markov on/off participation + staleness weighting.

    The defaults give a stationary on-fraction of 2/3, mean outages of
    ``1/p_up = 2.5`` rounds and a 10 % deadline-miss rate::

        Engine(cfg, 16, UnstableParticipation(p_up=0.2, p_down=0.2))
    """

    def __init__(self, p_up: float = 0.4, p_down: float = 0.2,
                 straggle_p: float = 0.1, gamma: float = 1.0):
        self.p_up, self.p_down = p_up, p_down
        self.straggle_p = straggle_p
        self.gamma = gamma

    def participation_process(self, cfg, n_clients: int,
                              seed: int) -> ArrivalProcess:
        return MarkovArrivalProcess(self.p_up, self.p_down,
                                    straggle_p=self.straggle_p, seed=seed)

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        ws = super().init_round(engine, ctx)
        ws["staleness"] = ctx.staleness
        return ws

    def aggregate(self, engine, ws):
        cfg = engine.cfg
        widths = engine.state.fleet.widths

        def agg_fn(globals_, stacked, depths, losses, mask):
            w = discounted_weights(engine, depths, losses, ws["staleness"],
                                   self.gamma, mask)
            return AGG.aggregate_weighted(cfg, globals_, stacked, depths, w,
                                          mask=mask,
                                          use_pallas=cfg.use_pallas,
                                          widths=widths, mesh=engine.mesh)
        return self._finish_aggregation(engine, ws, ws["server_view"],
                                        agg_fn)
