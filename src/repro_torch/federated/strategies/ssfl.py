"""SuperSFL — the paper's method, as an engine strategy.

Resource-aware depths (Eq. 1), TPGF gradient fusion (Alg. 2),
fault-tolerant fallback (Alg. 3), Eq. 6/8 client-server aggregation. ONE
shared main-server model per round, updated with each cohort's pooled
gradient (Alg. 2 line 11).

A cohort's local steps are a plain loop: per step, every real client of
the cohort computes TPGF against the same server params; the pooled
server gradient is the mean over the cohort's clients (an unreachable
client contributes its zero gradient); the server then updates once. If
no client of the cohort reached the server, the server does not update
at all (the frozen-server gate). Each client's tree is sliced at its
depth ``d`` — the reference's masked full-stack scan and its padded
bucket slots exist only for XLA's compile key, which eager PyTorch does
not have.

The client / local-head optimizer states are re-initialized per cohort
(clients re-download their subnetwork every round), while the shared
server branch's moments persist across rounds in
``TrainState.opt_state["server"]``.

Width tiers: a cohort splits into same-width groups (sorted by width,
ids in cohort order: the order the batch stream is drawn in). Under
``cross_tier="fused"`` every group trains from the SAME server snapshot
and the per-tier server updates, params and moments, fuse into ONE update
with ``tpgf.fuse_tiers`` (Eq. 6-style tier masses, delta mode); under
``"chained"`` each group continues from the previous group's server
branch. The snapshot needs no copy: the optimizers and ``apply_updates``
build new tensors and never write the server params or moments in place.

Departures from the reference: (a) ``aggregate`` passes
``cfg.use_pallas`` to ``core.aggregation.aggregate``, so Eq. 8 runs through
the hand-written ``aggregate`` kernel on the main path (the reference's
call omits the flag); ``tests/test_torch_aggregation.py`` and
``tests/test_torch_width.py`` hold it to the reference's plain path.
(b) The server view of a depth-``d`` cohort holds only stack rows
``[d:]``, so ``fuse_tiers`` fuses those rows; the reference fuses its
full-``L`` rows, of which rows ``[:d]`` come back unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core import supernet as SN
from repro_torch.core import tpgf as T
from repro_torch.federated.strategies import base
from repro_torch.federated.strategies.base import (CohortResult, RoundContext,
                                                   Strategy, register_strategy)
from repro_torch.optim import apply_updates
from repro_torch.tree import tree_map, tree_structure


@register_strategy("ssfl")
class SuperSFL(Strategy):

    kernel_name = "cohort_kernel"

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        sname = engine.cfg.split_stack_name
        ws = base.fleet_workspace(engine)
        # running server view: full-L split stack + non-stack server leaves
        ws["server_view"] = {sname: dict(engine.state.params[sname])}
        return ws

    @staticmethod
    def _width_groups(engine, ids):
        """Same-width sub-cohorts, sorted by width, ids in cohort order. A
        full-width fleet gives the single group ``[(1.0, ids)]``."""
        widths = engine.state.fleet.widths
        groups: Dict[float, list] = {}
        for i in np.asarray(ids):
            groups.setdefault(float(widths[i]), []).append(int(i))
        return [(w, np.asarray(g)) for w, g in sorted(groups.items())]

    def cohort_step(self, engine, ctx, ws, d, ids) -> CohortResult:
        cfg, state = engine.cfg, engine.state
        sname = cfg.split_stack_name
        base_server = SN.split_params(cfg, state.params, d)[1]
        srv_template, srv_full, base_state = base.cohort_server_opt(
            engine, cfg, sname, d)
        groups = self._width_groups(engine, ids)
        fused = len(groups) > 1 and engine.cross_tier == "fused"
        server_p, srv_state = base_server, base_state
        tiers, tier_states, live = [], [], []
        losses = None
        csum = 0
        for w, gids in groups:
            client_p = SN.split_params(cfg, state.params, d, w)[0]
            # fused: every tier from the same snapshot; chained: from the
            # previous tier's server branch
            src = (base_server, base_state) if fused \
                else (server_p, srv_state)
            server_p, srv_state, losses, mass = self._run_subcohort(
                engine, ctx, ws, d, gids, client_p, *src, width=w)
            if fused:
                tiers.append(T.TierUpdate(1.0, mass, server_p))
                tier_states.append(srv_state)
                live.append(bool(ctx.avail[gids].any()))
            csum += len(gids) * base.split_param_counts(
                cfg, state.params, d, w)[0]
        if fused:
            # the server branch is full width (the smashed data is full
            # d_model): each tier enters at width 1.0 with its mass, and
            # delta mode keeps an all-frozen cohort a bit-exact no-op
            server_p = T.fuse_tiers(cfg, tiers, base=base_server,
                                    use_pallas=cfg.use_pallas)
            srv_state = self._fuse_server_state(
                cfg, base_state, tier_states, [t.weight for t in tiers],
                live, base_server)
        state.opt_state["server"] = base.merge_server_opt(
            srv_full, srv_state, srv_template, sname, d)
        cparams = csum // max(len(ids), 1)
        sparams = base.split_param_counts(cfg, state.params, d)[1]
        return CohortResult(cparams, sparams, payload=server_p,
                            losses=losses)

    @staticmethod
    def _fuse_server_state(cfg, base_state, tier_states, masses, live,
                           server_tpl):
        """Cross-tier fusion of the server optimizer state: moment entries
        (trees shaped like the server branch) fuse in delta mode with the
        parameters' tier masses; bookkeeping entries (AdamW's ``t``) come
        from the first live tier, or the base when the whole cohort was
        frozen. ``live`` is the host availability draw (no sync)."""
        if not isinstance(base_state, dict):
            return base_state                      # stateless (sgd)
        pdef = tree_structure(server_tpl)
        first_live = next((i for i, lv in enumerate(live) if lv), None)
        out = {}
        for k, bv in base_state.items():
            if tree_structure(bv) == pdef:
                out[k] = T.fuse_tiers(
                    cfg, [T.TierUpdate(1.0, m, ts[k])
                          for m, ts in zip(masses, tier_states)], base=bv)
            else:
                out[k] = bv if first_live is None \
                    else tier_states[first_live][k]
        return out

    def _run_subcohort(self, engine, ctx, ws, d, ids, client_p, server_p,
                       srv_state, batch_size: int = None,
                       width: float = 1.0):
        """All local steps for the clients ``ids`` of depth ``d`` and width
        tier ``width`` (``client_p`` is already that slice). Returns
        ``(server_p, srv_state, losses, mass)``: the group's server branch
        (rows ``[d:]``), its optimizer state, each client's final-step
        loss (the fused loss where it reached the server, else its own)
        and the group's Eq. 6-style tier mass for ``fuse_tiers``: summed
        inverse fused losses over the clients that reached the server
        (exactly 0 for an all-frozen group)."""
        cfg, state, opt = engine.cfg, engine.state, engine.optimizer
        wcfg = SN.width_cfg(cfg, width)
        bs = engine.batch_size if batch_size is None else batch_size
        dev = engine.device
        ids = np.asarray(ids)
        n = len(ids)
        avail = np.asarray(ctx.avail[ids], bool)
        reached = bool(avail.any())
        idx = torch.as_tensor(
            ctx.sample_indices(ids, engine.local_steps, bs).astype(np.int64),
            device=dev)
        dd = engine.device_data
        # width slices are strided views: the copies are made contiguous
        # once here, for the kernels downstream
        clients = [tree_map(lambda x: x.clone(
            memory_format=torch.contiguous_format), client_p)
            for _ in range(n)]
        heads = [state.head_for(int(i)) for i in ids]
        eph = [opt.init({"client": c, "local": h})
               for c, h in zip(clients, heads)]
        l_c = l_s = None
        for t in range(engine.local_steps):
            g_sum = None
            lc, ls = [], []
            for j in range(n):
                rows = idx[t, j]
                batch = {"images": dd.images[rows], "label": dd.labels[rows]}
                out = T.tpgf_grads_split(cfg, wcfg, clients[j], server_p,
                                         heads[j], batch, d,
                                         server_available=bool(avail[j]))
                g_sum = out.g_server if g_sum is None else tree_map(
                    torch.add, g_sum, out.g_server)
                groups = {"client": clients[j], "local": heads[j]}
                upd, eph[j] = opt.update(
                    {"client": out.g_client, "local": out.g_local},
                    eph[j], groups)
                new = apply_updates(groups, upd)
                clients[j], heads[j] = new["client"], new["local"]
                lc.append(out.loss_client)
                ls.append(out.loss_server)
            # Alg. 2 line 11: ONE shared server model, updated once per step
            # with the cohort's pooled gradient; frozen if nobody reached it
            if reached:
                g_mean = tree_map(lambda g: g / float(n), g_sum)
                srv_upd, srv_state = opt.update(g_mean, srv_state, server_p)
                server_p = apply_updates(server_p, srv_upd)
            l_c, l_s = torch.stack(lc), torch.stack(ls)
        base.scatter_heads(state, ids, heads)
        base.scatter_client_rows(cfg, ws, ids, clients, d, width)
        avail_t = torch.as_tensor(avail, device=dev)
        losses = torch.where(
            avail_t,
            T.fused_loss(l_c, l_s, d, cfg.split_stack_len - d, cfg.tpgf_eps,
                         cfg.tpgf_variant),
            l_c)
        base.record_cohort(ws, ids, losses)
        mass = torch.sum(torch.where(
            avail_t, 1.0 / (losses + cfg.tpgf_eps),
            torch.zeros((), dtype=torch.float32, device=dev)))
        return server_p, srv_state, losses, mass

    def fold_server(self, engine, ws, d, ids, res) -> None:
        # the cohort trained stack rows [d:]; rows [:d] keep the view's
        sname = engine.cfg.split_stack_name
        server_p, sv = res.payload, ws["server_view"]
        sv[sname] = tree_map(lambda full, nd: torch.cat([full[:d], nd], 0),
                             sv[sname], server_p[sname])
        for k, v in server_p.items():
            if k != sname:
                sv[k] = v

    def aggregate(self, engine, ws):
        # Eq. 6 weights (depth x inverse fused loss) + Eq. 8 averaging;
        # use_pallas sends the split stack through the aggregate kernel,
        # and narrow clients switch on per-coordinate denominators
        cfg = engine.cfg
        widths = engine.state.fleet.widths
        return self._finish_aggregation(
            engine, ws, ws["server_view"],
            lambda g, s, dep, l, m: AGG.aggregate(
                cfg, g, s, dep, l, mask=m, use_pallas=cfg.use_pallas,
                widths=widths)[0])

    def comm_cost(self, engine, d, available, ids=None):
        # only the client subnetwork crosses the network (paper §III-C);
        # fallback mode skips the smashed-activation traffic. The smashed
        # data is full d_model at every width, so only the parameter
        # download scales with each client's width tier; without ``ids``
        # (the three-argument protocol) one full-width scalar
        per_step = 2 * engine.smashed_bytes(d) if available else 0
        msgs = 2 + 2 * engine.local_steps
        if ids is None:
            pbytes = SN.client_param_bytes(engine.cfg, engine.state.params,
                                           d)
            return 2 * pbytes + engine.local_steps * per_step, msgs
        widths = engine.state.fleet.widths
        by_tier: Dict[float, int] = {}
        for w in {float(widths[i]) for i in ids}:
            by_tier[w] = SN.client_param_bytes(engine.cfg,
                                               engine.state.params, d, w)
        pbytes = np.array([by_tier[float(widths[i])] for i in ids],
                          np.int64)
        return 2 * pbytes + engine.local_steps * per_step, msgs
