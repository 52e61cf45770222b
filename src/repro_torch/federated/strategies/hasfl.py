"""HASFL-style heterogeneity-aware batch/split co-tuning (Lin et al.).

SuperSFL's round with the fleet re-tuned EVERY round: instead of each
client's Eq. 1 capacity depth and one global batch size, the strategy
picks a (split depth, batch size[, width tier]) per client from the
device model's compute and communication estimates
(``core.allocation.co_tune``), so fast devices grow their batches while
stragglers shed depth and batch instead of stalling the round barrier.

The solve runs in ``init_round`` (it needs the live parameter tree for
the per-depth parameter counts). Depths go into ``fleet.depths`` (never
above ``fleet.capacity``), and ``cohort_step`` splits each same-depth
cohort into same-(batch, width) sub-cohorts, run through the inherited
``SuperSFL._run_subcohort``:

  * chained (one width, or ``cross_tier="chained"``): the groups in
    ``sorted((batch, width))`` order, each from the previous group's
    server branch and moments (Alg. 2 line 11's pooled sequential
    update at sub-cohort granularity);
  * fused (several widths and ``cross_tier="fused"``): width by width,
    batch groups within a tier chained from ONE server snapshot, the
    tiers' results fused into one update by ``tpgf.fuse_tiers``, the
    tier mass summed over its batch groups.

Both orders are the reference's, so the batch stream (drawn from
``state.rng`` in call order) gives every group the reference's batches.

Departure from the reference, (b) extended: the sub-cohorts run the
static depth-``d`` views (``supernet.split_params(cfg, params, d, w)``,
``base.cohort_server_opt(engine, cfg, sname, d)``) where the reference
runs full-``L`` views at runtime depth; the server moments are sliced at
rows ``[d:]`` and merged back at the cohort's own ``d``, which re-tuning
may move from round to round.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import allocation as AL
from repro_torch.core import supernet as SN
from repro_torch.core import tpgf as T
from repro_torch.federated.strategies import base
from repro_torch.federated.strategies.base import (CohortResult, RoundContext,
                                                   register_strategy)
from repro_torch.federated.strategies.ssfl import SuperSFL
from repro_torch.tree import tree_leaves


@register_strategy("hasfl")
class HASFL(SuperSFL):
    """Per-round joint depth/batch (and, with ``width_tiers``, width)
    co-tuning on the SuperSFL round."""

    def __init__(self, batch_choices=(4, 8, 16, 32),
                 time_budget_factor: float = 1.0, width_tiers=None):
        self.batch_choices = tuple(batch_choices)
        self.time_budget_factor = time_budget_factor
        # a supernet width ladder, e.g. (0.5, 0.75, 1.0): co_tune then
        # also picks each client's tier, into fleet.widths
        self.width_tiers = None if width_tiers is None \
            else tuple(sorted(width_tiers))
        self._dm = None
        self._bs: np.ndarray = None        # [N] per-client batch size

    def prepare_fleet(self, cfg, fleet, device_model=None) -> None:
        """Record the device model; the solve runs every ``init_round``."""
        self._dm = device_model

    def retune(self, engine) -> None:
        """Re-solve every client's (depth, batch[, width]) from the cost
        model, over the live tree's per-depth parameter counts."""
        cfg, fleet = engine.cfg, engine.state.fleet
        dm = self._dm or engine.accountant.dm
        params = engine.state.params
        sname = cfg.split_stack_name
        per_layer = sum(x.numel() // x.shape[0]
                        for x in tree_leaves(params[sname]))
        input_side = sum(x.numel() for x in tree_leaves(
            SN.split_params(cfg, params, 0)[0]))
        counts = np.array([input_side + d * per_layer
                           for d in range(cfg.split_stack_len + 1)])
        tps = engine.tokens_per_sample()
        tuned = AL.co_tune(
            fleet.capacity,
            [p.mem_gb for p in fleet.profiles],
            [p.lat_ms for p in fleet.profiles],
            counts, tps, tps * cfg.d_model * 4,
            batch_choices=self.batch_choices,
            base_batch=engine.batch_size,
            time_budget_factor=self.time_budget_factor,
            gflops_per_mem=dm.client_gflops_per_mem,
            bandwidth_mb_s=dm.bandwidth_mb_s,
            width_tiers=self.width_tiers)
        if self.width_tiers is not None:
            depths, self._bs, fleet.widths = tuned
        else:
            depths, self._bs = tuned
        fleet.depths = depths
        fleet.feasible = fleet.depths <= fleet.capacity

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        self.retune(engine)
        return super().init_round(engine, ctx)

    def cohort_step(self, engine, ctx, ws, d, ids) -> CohortResult:
        cfg, state = engine.cfg, engine.state
        sname = cfg.split_stack_name
        base_server = SN.split_params(cfg, state.params, d)[1]
        srv_template, srv_full, base_state = base.cohort_server_opt(
            engine, cfg, sname, d)
        widths = state.fleet.widths
        groups: Dict[tuple, list] = {}
        for i in np.asarray(ids):
            groups.setdefault((int(self._bs[i]), float(widths[i])),
                              []).append(int(i))
        wkeys = sorted({w for _, w in groups})
        client_views = {w: SN.split_params(cfg, state.params, d, w)[0]
                        for w in wkeys}
        if len(wkeys) > 1 and engine.cross_tier == "fused":
            tiers, tier_states, live = [], [], []
            for w in wkeys:
                t_server, t_state = base_server, base_state
                mass = torch.zeros((), dtype=torch.float32,
                                   device=engine.device)
                any_live = False
                for (b, w2), gids in sorted(groups.items()):
                    if w2 != w:
                        continue
                    t_server, t_state, _, m = self._run_subcohort(
                        engine, ctx, ws, d, np.asarray(gids),
                        client_views[w], t_server, t_state, batch_size=b,
                        width=w)
                    mass = mass + m
                    any_live = any_live or bool(ctx.avail[gids].any())
                tiers.append(T.TierUpdate(1.0, mass, t_server))
                tier_states.append(t_state)
                live.append(any_live)
            server_p = T.fuse_tiers(cfg, tiers, base=base_server,
                                    use_pallas=cfg.use_pallas)
            srv_state = self._fuse_server_state(
                cfg, base_state, tier_states, [t.weight for t in tiers],
                live, base_server)
        else:
            server_p, srv_state = base_server, base_state
            for (b, w), gids in sorted(groups.items()):
                server_p, srv_state, _, _ = self._run_subcohort(
                    engine, ctx, ws, d, np.asarray(gids), client_views[w],
                    server_p, srv_state, batch_size=b, width=w)
        state.opt_state["server"] = base.merge_server_opt(
            srv_full, srv_state, srv_template, sname, d)
        cparams, sparams = base.split_param_counts(cfg, state.params, d)
        mean_b = float(np.mean([self._bs[i] for i in np.asarray(ids)]))
        return CohortResult(cparams, sparams, payload=server_p,
                            tokens_per_batch=int(
                                mean_b * engine.tokens_per_sample()))

    def comm_cost(self, engine, d, available, ids=None):
        """ssfl's cost with the smashed traffic at each client's TUNED
        batch: with ``ids``, per-client arrays aligned with them (each
        client's parameter download at its own width tier); without, the
        fleet-mean batch of depth ``d`` (the three-argument protocol)."""
        cfg, params = engine.cfg, engine.state.params
        pbytes = SN.client_param_bytes(cfg, params, d)
        # smashed bytes per sample, in the model's compute dtype
        per_tok = engine.smashed_bytes(d) // engine.batch_size
        msgs = 2 + 2 * engine.local_steps
        if ids is not None and self._bs is not None:
            ids = np.asarray(ids)
            bs = self._bs[ids].astype(np.float64)
            per_step = 2 * (bs * per_tok).astype(np.int64) if available \
                else np.zeros(len(bs), np.int64)
            widths = engine.state.fleet.widths
            if bool((np.asarray(widths) < 1.0).any()):
                # width-tiered download: each client ships only its slice
                by_tier: Dict[float, int] = {}
                pbytes = np.array(
                    [by_tier.setdefault(
                        float(widths[i]),
                        SN.client_param_bytes(cfg, params, d,
                                              float(widths[i])))
                     for i in ids], np.int64)
            return (2 * pbytes + engine.local_steps * per_step,
                    np.full(len(bs), msgs, np.int64))
        mean_b = None
        if self._bs is not None:
            mask = engine.state.fleet.depths == d
            if mask.any():
                mean_b = float(self._bs[mask].mean())
        if mean_b is None:   # before the first round: the engine default
            mean_b = float(engine.batch_size)
        per_step = 2 * int(mean_b * per_tok) if available else 0
        return 2 * pbytes + engine.local_steps * per_step, msgs
