"""SplitFed baselines (SFL and dynamic-split DFL) as engine strategies.

SplitFedV1: the server keeps a PER-CLIENT copy of the server branch,
trained on that client's smashed stream, and the copies are fed-averaged
at the end of the round. Client gradients come only from the server
branch (no local classifier); a stalled client (server unreachable) gets
a bit-exact zero update on both sides and its server moments stay frozen.

  sfl — one rigid mid-stack split point for every client; clients whose
        Eq. 1 capacity is below it cannot participate.
  dfl — resource-aware depths as in ``ssfl`` (Samikwa et al.), but
        server-gradient-only training and depth-weighted FedAvg.

A cohort's local steps are a plain loop over steps and clients, as in
``ssfl``. The client optimizer state is per round (clients re-download
their subnetwork); the server moments persist across rounds in
``TrainState.opt_state["server"]``: each same-width group broadcasts the
shared moments onto its per-client copies and folds their mean back, and
the groups of one cohort chain through those moments. Bookkeeping entries
(AdamW's step count) advance in a step only if some client of the group
is live.

On a fleet mesh a client's server copy and its moments live on the rank
that owns the client: each rank trains its own clients' copies, and the
fed-average over the copies (``fold_server``, ``aggregate``) and the
moments' mean (``base.mean_server_opt``) are all-reduced partial
sums.

Departures from the reference: (a) ``aggregate`` passes
``cfg.use_pallas`` to ``core.aggregation.aggregate_weighted``, so Eq. 8
of the split stack runs through the hand-written ``aggregate`` kernel
(the reference's call omits the flag). (b) A depth-``d`` cohort's server
copies and moments hold only stack rows ``[d:]``, so the port needs
none of the reference's ``depth_freeze`` calls (they exist for its
masked full-``L`` scan); the fed-average over the copies touches the same
rows ``[d:]`` as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core import supernet as SN
from repro_torch.federated import metrics as MET
from repro_torch.federated.strategies import base
from repro_torch.federated.strategies.base import (CohortResult, RoundContext,
                                                   Strategy, register_strategy)
from repro_torch.federated.strategies.ssfl import SuperSFL
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim import apply_updates
from repro_torch.tree import (grad_leaves, tree_flatten_with_path,
                              tree_get, tree_map, tree_structure,
                              tree_unflatten)


def _split_grads(cfg, wcfg, client_p, server_p, batch):
    """(loss, client grads, server grads) of the server loss through the
    client prefix: the SplitFed step has no local head."""
    c_paths, c_leaves = grad_leaves(client_p)
    s_paths, s_leaves = grad_leaves(server_p)
    z, _ = M.client_apply(wcfg, tree_unflatten(c_paths, c_leaves), batch)
    loss = M.server_split_loss(cfg, tree_unflatten(s_paths, s_leaves), z,
                               batch)
    grads = torch.autograd.grad(loss, c_leaves + s_leaves)
    nc = len(c_leaves)
    return (loss.detach(), tree_unflatten(c_paths, grads[:nc]),
            tree_unflatten(s_paths, grads[nc:]))


class SplitFedBase(Strategy):
    """Shared SFL/DFL round logic; subclasses pick split and weighting."""

    kernel_name = "cohort_kernel"

    def client_weights(self, depths, mask) -> np.ndarray:
        """[N] fp32 aggregation weights over the full fleet; ``mask``
        marks the clients that trained this round (0 elsewhere)."""
        raise NotImplementedError

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        cfg, state = engine.cfg, engine.state
        sname = cfg.split_stack_name
        ws = base.fleet_workspace(engine)
        # accumulators of the FedAvg over per-client server copies
        ws.update({"num_stack": tree_map(
                       lambda x: torch.zeros_like(x, dtype=torch.float32),
                       state.params[sname]),
                   "den_rows": np.zeros(cfg.split_stack_len),
                   "num_other": {},
                   "den_other": 0})
        return ws

    def cohort_step(self, engine, ctx, ws, d, ids) -> CohortResult:
        """Split the depth-``d`` cohort into same-width groups and CHAIN
        them through the shared server moments: each group's per-client
        copies start from the previous group's fed-averaged moments, and
        every group's server copies start from the round's server
        branch."""
        cfg, state = engine.cfg, engine.state
        sname = cfg.split_stack_name
        server_p = SN.split_params(cfg, state.params, d)[1]
        srv_template, srv_full, srv_slice = base.cohort_server_opt(
            engine, cfg, sname, d)
        folds, losses, csum = [], None, 0
        for w, gids in SuperSFL._width_groups(engine, ids):
            client_p = SN.split_params(cfg, state.params, d, w)[0]
            copies, srv_slice, losses = self._run_subcohort(
                engine, ctx, ws, d, gids, client_p, server_p, srv_slice,
                width=w)
            folds.append(copies)
            csum += len(gids) * base.split_param_counts(
                cfg, state.params, d, w)[0]
        state.opt_state["server"] = base.merge_server_opt(
            srv_full, srv_slice, srv_template, sname, d)
        cparams = csum // max(len(ids), 1)
        sparams = base.split_param_counts(cfg, state.params, d)[1]
        return CohortResult(cparams, sparams, payload=folds, losses=losses)

    def _run_subcohort(self, engine, ctx, ws, d, ids, client_p, server_p,
                       srv_slice, width: float = 1.0):
        """All local steps of the same-width group ``ids``: per-client
        client and server copies, each stepped on its own server-loss
        gradients. Returns ``(server copies, srv_slice, losses)``: the
        trained copies (rows ``[d:]``), the group's fed-averaged server
        state and each client's final-step loss; on a fleet mesh the
        copies and losses of the clients this rank owns."""
        cfg, opt = engine.cfg, engine.optimizer
        wcfg = SN.width_cfg(cfg, width)
        dev = engine.device
        ids = np.asarray(ids)
        n = len(ids)
        avail = np.asarray(ctx.avail[ids], bool)
        anyav = bool(avail.any())
        idx = torch.as_tensor(
            ctx.sample_indices(ids, engine.local_steps,
                               engine.batch_size).astype(np.int64),
            device=dev)
        dd = engine.device_data
        mine = np.where(engine.owned(ids))[0]   # the cohort positions here
        m = len(mine)
        # the optimizers and apply_updates build new tensors, so the
        # copies may start as shared references to one tree
        clients = [client_p] * m
        servers = [server_p] * m
        eph = [opt.init(client_p) for _ in range(m)]
        srv = base.broadcast_server_opt(srv_slice, m)
        pdef = tree_structure(server_p)
        losses = [None] * m
        for t in range(engine.local_steps):
            book = None
            for j, i in enumerate(mine):
                rows = idx[t, i]
                batch = {"images": dd.images[rows], "label": dd.labels[rows]}
                if not avail[i]:
                    # a stalled client: zero update on both sides, frozen
                    # moments; its loss still counts
                    with torch.no_grad():
                        z, _ = M.client_apply(wcfg, clients[j], batch)
                        losses[j] = M.server_split_loss(cfg, servers[j], z,
                                                        batch)
                    continue
                losses[j], gc, gs = _split_grads(cfg, wcfg, clients[j],
                                                 servers[j], batch)
                upd, eph[j] = opt.update(gc, eph[j], clients[j])
                clients[j] = apply_updates(clients[j], upd)
                upd, new = opt.update(gs, srv[j], servers[j])
                servers[j] = apply_updates(servers[j], upd)
                if isinstance(new, dict):
                    srv[j] = {k: v for k, v in new.items()
                              if tree_structure(v) == pdef}
                    book = {k: v for k, v in new.items()
                            if tree_structure(v) != pdef}
            # shared bookkeeping advances iff some client was live
            if book:
                for s in srv:
                    s.update(book)
        base.scatter_client_rows(cfg, ws, ids[mine], clients, d, width)
        loss_t = (torch.stack(losses).to(torch.float32) if m else
                  torch.zeros(0, dtype=torch.float32, device=dev))
        base.record_cohort(ws, ids[mine], loss_t)
        if anyav:
            # the live bookkeeping is on the rank of the first live client
            src = int(engine.owner_of(ids[np.argmax(avail)]))
            srv_slice = base.mean_server_opt(srv, srv_slice, server_p, n,
                                             src, engine.mesh)
        return servers, srv_slice, loss_t

    def fold_server(self, engine, ws, d, ids, res) -> None:
        """Sum each group's server copies into the FedAvg accumulators:
        the split stack's rows ``[d:]`` over ``den_rows[d:]``, the
        non-stack server leaves over ``den_other``. A stalled client's
        unchanged copy counts like any other."""
        sname = engine.cfg.split_stack_name
        groups = SuperSFL._width_groups(engine, ids)
        for copies, (_, gids) in zip(res.payload, groups):
            # on a fleet mesh: this rank's copies, maybe none, of the
            # group's len(gids)
            count = len(gids)
            total = lambda *xs: torch.stack([x.float() for x in xs]).sum(0)
            summed = tree_map(total, *copies) if copies else tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32),
                SN.split_params(engine.cfg, engine.state.params, d)[1])
            for path, acc in tree_flatten_with_path(ws["num_stack"]):
                acc[d:] += tree_get(summed[sname], path)
            ws["den_rows"][d:] += count
            for k, v in summed.items():
                if k == sname:
                    continue
                ws["num_other"][k] = v if k not in ws["num_other"] \
                    else tree_map(torch.add, ws["num_other"][k], v)
            ws["den_other"] += count

    def aggregate(self, engine, ws):
        cfg, state = engine.cfg, engine.state
        sname = cfg.split_stack_name
        dev = engine.device
        den_rows = ws["den_rows"]
        # the fed-average's partial sums, over every rank's copies
        ws["num_stack"], ws["num_other"] = SH.fleet_sum_tree(
            (ws["num_stack"], ws["num_other"]), engine.mesh)
        den = torch.as_tensor(np.maximum(den_rows, 1e-9),
                              dtype=torch.float32, device=dev)
        has = torch.as_tensor(den_rows > 0, device=dev)

        def rows(x, n):
            return x.reshape((-1,) + (1,) * (n.dim() - 1))

        # FedAvg of the per-client server copies into the server view;
        # rows no cohort trained keep the global value
        server_view: Dict[str, Any] = {sname: tree_map(
            lambda n, g: torch.where(rows(has, n), n / rows(den, n),
                                     g.float()).to(g.dtype),
            ws["num_stack"], state.params[sname])}
        for k, v in ws["num_other"].items():
            server_view[k] = tree_map(
                lambda n, g: (n / max(ws["den_other"], 1)).to(g.dtype),
                v, state.params[k])
        widths = state.fleet.widths
        return self._finish_aggregation(
            engine, ws, server_view,
            lambda g, s, dep, l, m: AGG.aggregate_weighted(
                cfg, g, s, dep,
                torch.as_tensor(self.client_weights(dep, m), device=dev),
                mask=m, use_pallas=cfg.use_pallas, widths=widths,
                mesh=engine.mesh))

    def comm_cost(self, engine, d, available, ids=None):
        # SplitFed ships BOTH client- and server-side nets through the fed
        # server each round; a stalled client moves no useful bytes. One
        # shared scalar for the whole cohort.
        pbytes = MET.tree_bytes(engine.state.params)
        total = 2 * pbytes + 2 * engine.smashed_bytes(d) * engine.local_steps
        return (total if available else 0, 2 + 2 * engine.local_steps)


@register_strategy("sfl")
class SplitFed(SplitFedBase):

    def fixed_depth(self, cfg):
        # SplitFed's rigid split: one fixed point (mid-stack) for everyone
        return max(cfg.split_stack_len // 2, 1)

    def client_weights(self, depths, mask):
        mask = np.asarray(mask, np.float32)
        return mask / mask.sum()


@register_strategy("dfl")
class DynamicSplitFed(SplitFedBase):

    def client_weights(self, depths, mask):
        w = depths.astype(np.float32) * np.asarray(mask, np.float32)
        return w / w.sum()
