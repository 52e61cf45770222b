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

Departure from the reference: ``aggregate`` passes ``cfg.use_pallas`` to
``core.aggregation.aggregate``, so Eq. 8 runs through the hand-written
``aggregate`` kernel on the main path (the reference's call omits the
flag); ``tests/test_torch_aggregation.py`` holds it to the reference's
plain path.
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
from repro_torch.tree import tree_map


@register_strategy("ssfl")
class SuperSFL(Strategy):

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        sname = SN.split_stack_name(engine.cfg)
        ws = base.fleet_workspace(engine)
        # running server view: full-L split stack + non-stack server leaves
        ws["server_view"] = {sname: dict(engine.state.params[sname])}
        return ws

    def cohort_step(self, engine, ctx, ws, d, ids) -> CohortResult:
        cfg, state = engine.cfg, engine.state
        sname = SN.split_stack_name(cfg)
        client_p, server_p, _ = SN.split_params(cfg, state.params, d)
        srv_template, srv_full, srv_state = base.cohort_server_opt(
            engine, cfg, sname, d)
        server_p, srv_state, losses = self._run_subcohort(
            engine, ctx, ws, d, ids, client_p, server_p, srv_state)
        state.opt_state["server"] = base.merge_server_opt(
            srv_full, srv_state, srv_template, sname, d)
        cparams, sparams = base.split_param_counts(cfg, state.params, d)
        return CohortResult(cparams, sparams, payload=server_p,
                            losses=losses)

    def _run_subcohort(self, engine, ctx, ws, d, ids, client_p, server_p,
                       srv_state, batch_size: int = None):
        """All local steps for the clients ``ids`` of depth ``d``. Returns
        ``(server_p, srv_state, losses)``: the cohort's server branch (rows
        ``[d:]``), its optimizer state, and each client's final-step loss
        (the fused loss where it reached the server, else its own)."""
        cfg, state, opt = engine.cfg, engine.state, engine.optimizer
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
        clients = [tree_map(torch.clone, client_p) for _ in range(n)]
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
                out = T.tpgf_grads_split(cfg, cfg, clients[j], server_p,
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
        base.scatter_client_rows(cfg, ws, ids, clients, d)
        avail_t = torch.as_tensor(avail, device=dev)
        losses = torch.where(
            avail_t,
            T.fused_loss(l_c, l_s, d, cfg.split_stack_len - d, cfg.tpgf_eps,
                         cfg.tpgf_variant),
            l_c)
        base.record_cohort(ws, ids, losses)
        return server_p, srv_state, losses

    def fold_server(self, engine, ws, d, ids, res) -> None:
        # the cohort trained stack rows [d:]; rows [:d] keep the view's
        sname = SN.split_stack_name(engine.cfg)
        server_p, sv = res.payload, ws["server_view"]
        sv[sname] = tree_map(lambda full, nd: torch.cat([full[:d], nd], 0),
                             sv[sname], server_p[sname])
        for k, v in server_p.items():
            if k != sname:
                sv[k] = v

    def aggregate(self, engine, ws):
        # Eq. 6 weights (depth x inverse fused loss) + Eq. 8 averaging;
        # use_pallas sends the split stack through the aggregate kernel
        cfg = engine.cfg
        return self._finish_aggregation(
            engine, ws, ws["server_view"],
            lambda g, s, dep, l, m: AGG.aggregate(
                cfg, g, s, dep, l, mask=m, use_pallas=cfg.use_pallas)[0])

    def comm_cost(self, engine, d, available):
        # only the client subnetwork crosses the network (paper §III-C);
        # fallback mode skips the smashed-activation traffic
        per_step = 2 * engine.smashed_bytes(d) if available else 0
        msgs = 2 + 2 * engine.local_steps
        pbytes = SN.client_param_bytes(engine.cfg, engine.state.params, d)
        return 2 * pbytes + engine.local_steps * per_step, msgs
