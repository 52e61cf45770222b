"""Buffered-async server aggregation (FedBuff-style) as an engine strategy.

``unstable`` *weights* by staleness; this strategy changes *when* the
global model moves. Cohort results become staleness-tagged deltas pushed
into the server-side ``federated.buffer`` (capacity K, flush policies),
and the globals advance only when the buffer flushes: the buffered deltas
collapse under the ``(1 + s)^-gamma`` discount into one pseudo-gradient,
stepped through a **server optimizer** (plain SGD or the FedOpt family,
``fedadam``/``fedyogi``) whose moments persist across rounds and
checkpoints in ``TrainState.opt_state["server_fedopt"]``.

Two server-side optimizer states coexist: ``opt_state["server"]``, the
moments of ``engine.optimizer`` that step the shared server branch in
every local step (the inherited SuperSFL cohort path; server compute goes
on between flushes), and ``opt_state["server_fedopt"]``, this strategy's
flush-time moments.

Entries are per **cohort**: ``fold_server`` records each cohort's
membership and its OWN server view (its trained rows ``[d:]`` laid over
the round-start stack, not the round's running view), and ``aggregate``
pushes, per cohort, the staleness-weighted Eq. 6/8 candidate restricted
to the cohort's trained clients minus the round-start globals, tagged
with the cohort's mean staleness. The flush check runs after every push,
so ``"count"`` fires at exactly K arrivals.

Invariants (held against the reference and within the port by
``tests/test_torch_async_buffer.py``): with the server unreachable, the
server-side leaves and both server states stay bit for bit through pushes
and flushes; ``BufferedAsync(capacity=1, policy="round",
server_opt="sgd", server_lr=1.0)`` on a one-depth fleet recovers
``unstable`` up to the float round trip ``params + (agg - params)``;
resume is bit-identical.

Departures from the reference: (a) extended: ``_cohort_entry`` passes
``cfg.use_pallas`` (and the fleet's widths) to ``aggregate_weighted``, so
each candidate's split stack runs through the ``aggregate`` kernel.
(b): the cohort payload holds rows ``[d:]`` only, so a cohort's view is
``cat([params[:d], payload])`` where the reference slices its full-``L``
payload.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core import supernet as SN
from repro_torch.federated import buffer as BUF
from repro_torch.federated.strategies import base
from repro_torch.federated.strategies.base import (RoundContext,
                                                   register_strategy)
from repro_torch.federated.strategies.unstable import (UnstableParticipation,
                                                       discounted_weights)
from repro_torch.optim import Optimizer, apply_updates, get_optimizer
from repro_torch.tree import tree_map

FEDOPT_SLOT = "server_fedopt"


@register_strategy("async_buffered")
class BufferedAsync(UnstableParticipation):
    """SuperSFL under Markov participation + FedBuff buffered folding.

    ``capacity``/``policy``/``max_age`` configure the buffer; ``gamma``
    drives both the per-client staleness weighting inside each cohort's
    candidate and the flush-time discount across entries; ``server_opt``
    (``"sgd"``, ``"fedadam"``, ``"fedyogi"`` or any
    ``repro_torch.optim.Optimizer``) and ``server_lr`` pick the flush
    optimizer::

        Engine(cfg, 16, BufferedAsync(capacity=4, server_opt="fedyogi",
                                      server_lr=0.3))
    """

    def __init__(self, capacity: int = 4, policy: str = "count",
                 max_age: int = None,
                 server_opt: Union[str, Optimizer] = "sgd",
                 server_lr: float = 1.0,
                 p_up: float = 0.4, p_down: float = 0.2,
                 straggle_p: float = 0.1, gamma: float = 1.0):
        super().__init__(p_up=p_up, p_down=p_down, straggle_p=straggle_p,
                         gamma=gamma)
        if policy not in BUF.POLICIES:
            raise ValueError(f"unknown flush policy {policy!r}; "
                             f"available: {BUF.POLICIES}")
        if policy == "age" and max_age is None:
            raise ValueError("policy='age' requires max_age")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity, self.policy, self.max_age = capacity, policy, max_age
        self._server_opt = (get_optimizer(server_opt, server_lr)
                            if isinstance(server_opt, str) else server_opt)
        self.flushes = 0      # lifetime flush counter

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        ws = super().init_round(engine, ctx)
        ws["cohort_ids"] = {}
        ws["cohort_views"] = {}
        return ws

    def fold_server(self, engine, ws, d, ids, res) -> None:
        """Record the cohort's membership and its OWN server view: its
        trained rows ``[d:]`` under the round-start rows ``[:d]``, and its
        non-stack server leaves. Not the running view: entries of one
        round may flush at different times, and a shared view would
        re-apply another cohort's server movement."""
        sname = SN.split_stack_name(engine.cfg)
        params = engine.state.params
        view = {sname: tree_map(lambda full, nd: torch.cat([full[:d], nd], 0),
                                params[sname], res.payload[sname])}
        for k, v in res.payload.items():
            if k != sname:
                view[k] = v
        ws["cohort_views"][d] = view
        ws["cohort_ids"][d] = np.asarray(ids)

    def aggregate(self, engine, ws):
        state = engine.state
        # the ONE host sync of the round's training outputs
        host = torch.stack([ws["trained"].float(), ws["losses"]]).cpu().numpy()
        mask, losses = host[0] > 0.5, host[1]
        loss = float(np.mean(losses[mask])) if mask.any() else float("nan")
        buf = self._buffer_state(engine)
        new_params = state.params
        if mask.any():
            ws["participated"] = np.where(mask)[0]
            stale = np.asarray(ws["staleness"], np.float64)
            for d, ids in ws["cohort_ids"].items():
                entry = self._cohort_entry(engine, ws, mask, stale, d, ids)
                if entry is None:
                    continue
                buf = BUF.push(buf, *entry, round_idx=state.round_idx)
                # the count policy fires at exactly K arrivals
                new_params, buf = self._maybe_flush(engine, new_params, buf)
        else:
            # no pushes this round; the age policy may still flush
            new_params, buf = self._maybe_flush(engine, new_params, buf)
        state.opt_state[BUF.SLOT] = buf
        return new_params, loss

    def _cohort_entry(self, engine, ws, mask, stale, d, ids):
        """One entry for one cohort: the staleness-weighted Eq. 6/8
        candidate over the cohort's trained clients, with the cohort's own
        server view over the round-start globals, minus those globals.
        Weight: the trained count; tag: their mean staleness. None if
        nobody of the cohort trained."""
        cfg, state = engine.cfg, engine.state
        cmask = np.zeros_like(mask)
        cmask[ids] = True
        cmask &= mask
        if not cmask.any():
            return None
        globals_with_server = dict(state.params)
        globals_with_server.update(ws["cohort_views"][d])
        w = discounted_weights(engine, state.fleet.depths, ws["losses"],
                               stale, self.gamma, cmask)
        cand = AGG.aggregate_weighted(
            cfg, globals_with_server, ws["client_stack"], state.fleet.depths,
            w, mask=cmask, use_pallas=cfg.use_pallas,
            widths=state.fleet.widths)
        delta = tree_map(lambda c, p: c.float() - p.float(), cand,
                         state.params)
        return delta, float(cmask.sum()), float(stale[cmask].mean())

    def _maybe_flush(self, engine, params, buf):
        """If the policy says so: flush the buffer and step ``params``
        through the persistent server optimizer with the pseudo-gradient
        ``-delta`` (SGD at lr 1.0 applies the delta verbatim)."""
        state = engine.state
        if not BUF.ready(buf, policy=self.policy, max_age=self.max_age,
                         round_idx=state.round_idx):
            return params, buf
        delta, buf = BUF.flush(buf, gamma=self.gamma,
                               round_idx=state.round_idx)
        cur = base.valid_opt_state(engine, self._server_opt, params,
                                   FEDOPT_SLOT, "_fedopt_ok")
        pseudo_grad = tree_map(torch.neg, delta)
        updates, cur = self._server_opt.update(pseudo_grad, cur, params)
        state.opt_state[FEDOPT_SLOT] = cur
        self.flushes += 1
        return apply_updates(params, updates), buf

    def _buffer_state(self, engine):
        """The persistent buffer from ``opt_state["update_buffer"]``, made
        fresh when absent or of another shape (another capacity or model).
        Validated once per (engine, strategy) and after every
        ``Engine.restore``. An adopted buffer's leaves become tensors of
        their own on the params' device: pushes write into them in place,
        and must never write through into the arrays they came from."""
        cur = engine.state.opt_state.get(BUF.SLOT)
        if cur is not None and getattr(engine, "_buffer_ok",
                                       None) == id(self):
            return cur
        params = engine.state.params
        want = BUF.init_buffer(base.meta_like(params), self.capacity)
        if cur is None or not base.state_like(cur, want):
            cur = BUF.init_buffer(params, self.capacity)
        else:
            dev = engine.device
            cur = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                           else torch.tensor(np.asarray(x), device=dev), cur)
        engine.state.opt_state[BUF.SLOT] = cur
        engine._buffer_ok = id(self)
        return cur
