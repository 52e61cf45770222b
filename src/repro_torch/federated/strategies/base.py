"""The Strategy protocol: what a federated method must supply.

The ``Engine`` owns everything method-independent — availability draws,
client sampling, staleness tracking, the batch RNG, cohorting, the
metrics ``Accountant``, history and eval. A ``Strategy`` supplies the
method-specific pieces:

  init_round   — allocate the per-round workspace
  cohort_step  — run ``local_steps`` updates for one same-depth cohort,
                 recording client trees / losses into the workspace
  fold_server  — fold a cohort's server-side result into the running
                 server view
  aggregate    — produce the next global params + the round's loss scalar
  comm_cost    — per-client bytes and message counts for the round
  slot_outputs — a cohort's per-client outputs, for the sanitizer's
                 slot attribution (``Engine(sanitize=True)``)

The port registers every strategy of the reference: ``ssfl``, the
SplitFed baselines ``sfl``/``dfl`` (``splitfed.py``), the FedAvg family
``fedavg``/``fedavgm``/``fedadam``/``fedyogi`` (``fedavg.py``) and the
scenario strategies ``unstable`` (``unstable.py``), ``async_buffered``
(``async_buffered.py``) and ``hasfl`` (``hasfl.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import supernet as SN
from repro_torch.core.fault import ArrivalProcess
from repro_torch.launch import sharding as SH
from repro_torch.optim import map_moments
from repro_torch.tree import (tree_flatten_with_path, tree_get, tree_leaves,
                              tree_map, tree_structure)


@dataclasses.dataclass
class RoundContext:
    """Engine-drawn randomness + bookkeeping for one round.

    avail          — [N] bool, server reachable this round
    participants   — [N] bool, client showed up (``sample_frac`` draw ∩
                     the participation process; all-True without them)
    batch_fn       — (ids, batch_size=None) -> one stacked host-drawn
                     batch per id (the legacy host path; it draws from
                     the same stream as ``sample_indices``, so a strategy
                     uses one or the other)
    sample_indices — (ids, steps, batch_size) -> [steps, len(ids), B]
                     int32 flat-dataset indices (the batch stream)
    staleness      — [N] int, rounds since each client last trained
    """
    avail: np.ndarray
    participants: np.ndarray
    batch_fn: Callable[..., Any] = None
    sample_indices: Callable[..., np.ndarray] = None
    staleness: np.ndarray = None


@dataclasses.dataclass
class CohortResult:
    """What ``cohort_step`` hands back for accounting + server folding."""
    client_params: int           # per-client trainable param count
    server_params: int           # server-side param count (0 => no server)
    payload: Any = None          # strategy-private, consumed by fold_server
    tokens_per_batch: int = None  # per-step tokens when a strategy tunes
    #                               batch sizes (None: the engine default)
    losses: Any = None           # [cohort] device tensor of final losses


class Strategy:
    """Base: shared hooks with no-op defaults."""

    name: str = "?"
    # what a sanitizer trip names: the reference's kernel for the method
    kernel_name: str = "cohort_step"

    def fixed_depth(self, cfg) -> Optional[int]:
        """A rigid split point for every client, or None for Eq.1 depths."""
        return None

    def prepare_fleet(self, cfg, fleet, device_model=None) -> None:
        """Post-allocation fleet adjustment."""

    def participation_process(self, cfg, n_clients: int,
                              seed: int) -> Optional[ArrivalProcess]:
        return None

    def cohorts(self, engine, ctx: RoundContext) -> Dict[int, np.ndarray]:
        """Feasible same-depth cohorts, restricted to sampled participants."""
        out: Dict[int, np.ndarray] = {}
        for d, ids in engine.state.fleet.cohorts().items():
            ids = ids[ctx.participants[ids]]
            if len(ids):
                out[d] = ids
        return out

    def init_round(self, engine, ctx: RoundContext) -> Dict[str, Any]:
        raise NotImplementedError

    def cohort_step(self, engine, ctx: RoundContext, ws: Dict[str, Any],
                    d: int, ids: np.ndarray) -> CohortResult:
        raise NotImplementedError

    def fold_server(self, engine, ws: Dict[str, Any], d: int,
                    ids: np.ndarray, res: CohortResult) -> None:
        pass

    def aggregate(self, engine, ws: Dict[str, Any]) -> Tuple[Any, float]:
        raise NotImplementedError

    def _finish_aggregation(self, engine, ws: Dict[str, Any],
                            server_view: Dict[str, Any],
                            agg_fn: Callable) -> Tuple[Any, float]:
        """Shared aggregation tail: merge this round's server view into the
        globals and delegate the weighting to
        ``agg_fn(globals, stacked, depths, losses, mask)``. This is the ONE
        host sync of the round's training outputs: the trained mask and the
        per-client losses come back together, the whole fleet's on every
        rank of a fleet mesh (``fleet_outputs``), so the Eq. 6 weights are
        the same everywhere; ``stacked`` holds the rank's own rows. Returns
        (new params, mean loss over the clients that trained)."""
        state = engine.state
        mask, losses = fleet_outputs(engine, ws)
        if not mask.any():
            return state.params, float("nan")
        ws["participated"] = np.where(mask)[0]
        globals_with_server = dict(state.params)
        globals_with_server.update(server_view)
        new_params = agg_fn(globals_with_server, ws["client_stack"],
                            state.fleet.depths, ws["fleet_losses"], mask)
        return new_params, float(np.mean(losses[mask]))

    def comm_cost(self, engine, d: int, available: bool,
                  ids=None) -> Tuple[np.ndarray, int]:
        """-> (bytes on the wire this round, messages) per client of the
        cohort ``ids`` of depth ``d``: int64 arrays aligned with ``ids``,
        or shared scalars. Without ``ids`` (the reference's
        three-argument protocol; a strategy may omit the parameter) it
        returns scalars."""
        raise NotImplementedError

    def slot_outputs(self, engine, ws: Dict[str, Any], ids: np.ndarray,
                     res: CohortResult) -> Dict[str, Any]:
        """The cohort's per-client outputs, every leaf leading with the
        cohort's axis (position ``j`` holds client ``ids[j]``): its losses,
        its rows of the workspace's client trees and of the local heads.
        On a fleet mesh, the clients of ``ids`` that this rank owns, in
        cohort order (``engine.owned(ids)`` maps them to cohort
        positions). The sanitizer reads them after a trip to name the
        positions whose outputs are non-finite."""
        ids = np.asarray(ids, np.int64)
        idx = torch.as_tensor(ids[engine.owned(ids)] - engine.state.rows[0],
                              device=engine.device)
        rows = lambda tree: tree_map(lambda x: x[idx], tree)
        out = {"local": rows(engine.state.local_heads)}
        if res.losses is not None:
            out["losses"] = res.losses
        if "client_stack" in ws:
            out["client"] = rows(ws["client_stack"])
        return out


# --------------------------------------------------- full-fleet workspace
#
# One round's training outputs land in full-fleet stacked buffers on the
# device: ``client_stack`` (input-side leaves [N, ...], split-stack leaves
# [N, L_full, ...] zero beyond each client's depth — the
# ``core.aggregation`` stacked format), ``losses`` [N] f32 and ``trained``
# [N] bool. Cohorts write their rows in place (the port updates these
# buffers in place to hold one copy of the fleet's client trees);
# aggregation reads them with the validity mask. On a fleet mesh each
# rank's buffers hold the rows of the clients it owns, ``ws["rows"]``
# (absent: every client's).

def fleet_workspace(engine) -> Dict[str, Any]:
    lo, hi = engine.state.rows
    n = hi - lo
    dev = engine.device
    template = SN.split_params(engine.cfg, engine.state.params, None)[0]
    return {"client_stack": tree_map(
                lambda x: torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                                      device=dev), template),
            "losses": torch.zeros(n, dtype=torch.float32, device=dev),
            "trained": torch.zeros(n, dtype=torch.bool, device=dev),
            "rows": (lo, hi)}


def fleet_outputs(engine, ws: Dict[str, Any]):
    """The round's trained mask and losses over the whole fleet, on the
    host (``[N]`` bool and fp32): ONE device sync; on a fleet mesh after
    one all-reduce that gathers every rank's rows bit for bit. The
    device vector of losses lands in ``ws["fleet_losses"]``."""
    out = SH.fleet_gather({"trained": ws["trained"], "losses": ws["losses"]},
                          engine.state.n_clients, engine.mesh)
    ws["fleet_losses"] = out["losses"]
    host = torch.stack([out["trained"].float(), out["losses"]]).cpu().numpy()
    return host[0] > 0.5, host[1]


@torch.no_grad()
def scatter_client_rows(cfg, ws: Dict[str, Any], ids, client_trees,
                        d: int, width: float = 1.0) -> None:
    """Write each client's trained tree (stack rows ``[:d]``, sliced to
    ``width``) into its row of ``ws["client_stack"]``, in place. Stack rows
    ``[d:]`` and the pruned channels of a width slice are written as
    zeros: presence masks the rows out at aggregation, and the
    per-coordinate width denominators the channels."""
    sname = cfg.split_stack_name
    plan = SN.width_plan(cfg, width) if width < 1.0 else {}
    buf = ws["client_stack"]
    for i, tree in zip(ids, client_trees):
        i = int(i) - ws.get("rows", (0,))[0]
        for k, v in tree.items():
            if k == sname:
                for path, x in tree_flatten_with_path(v):
                    dst = tree_get(buf[k], path)
                    rows = dst[i, :d]
                    name = SN._leaf_name(path)
                    if name in plan:
                        ax, keep = plan[name]
                        axis = rows.dim() + ax
                        rows.narrow(axis, 0, keep).copy_(x)
                        rows.narrow(axis, keep,
                                    rows.shape[axis] - keep).zero_()
                    else:
                        rows.copy_(x)
                    dst[i, d:].zero_()
            else:
                buf[k][i].copy_(v)


@torch.no_grad()
def scatter_heads(state, ids, heads) -> None:
    """Write each client's trained phi_i into its row of the stacked
    ``state.local_heads`` (in place)."""
    for i, head in zip(ids, heads):
        r = state.row(i)
        tree_map(lambda buf, h: buf[r].copy_(h), state.local_heads, head)


def record_cohort(ws: Dict[str, Any], ids, losses) -> None:
    """Mark a cohort's rows trained and write their losses (device only)."""
    lo = ws.get("rows", (0,))[0]
    idx = torch.as_tensor(np.asarray(ids, np.int64) - lo,
                          device=ws["losses"].device)
    ws["losses"][idx] = losses.to(torch.float32)
    ws["trained"][idx] = True


def split_param_counts(cfg, params, d: int, width: float = 1.0):
    """(client, server) parameter counts of the depth-``d``, width-``width``
    split (views: no device work)."""
    c, s, _ = SN.split_params(cfg, params, d, width)
    count = lambda t: sum(int(x.numel()) for x in tree_leaves(t))
    return count(c), count(s)


# ----------------------------------------------- persistent server opt state
#
# The shared server branch's optimizer state lives in
# ``TrainState.opt_state["server"]``, shaped over the FULL server branch
# (the d=0 view: whole split stack + non-stack server leaves). A cohort of
# depth d slices moment rows ``[d:]``, steps them, and writes them back.

def state_like(state, shaped) -> bool:
    """Same tree and the same leaf shapes (``shaped`` may live on the
    ``meta`` device)."""
    if tree_structure(state) != tree_structure(shaped):
        return False
    return all(tuple(a.shape) == tuple(b.shape)
               for a, b in zip(tree_leaves(state), tree_leaves(shaped)))


def meta_like(tree):
    """``tree``'s shapes and dtypes on the ``meta`` device (no storage)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def valid_opt_state(engine, opt, template, slot: str = "server",
                    ok: str = "_server_opt_ok") -> Any:
    """``engine.state.opt_state[slot]`` if it has the shape
    ``opt.init(template)`` would give, else a fresh ``opt.init(template)``
    (stored back). The check builds ``opt``'s state on the ``meta``
    device, so it allocates nothing; it runs once per (engine, optimizer)
    and again after every ``Engine.restore``, which resets the engine's
    ``ok`` attribute (``_server_opt_ok`` for the server moments,
    ``_fedopt_ok`` for ``async_buffered``'s flush moments)."""
    cur = engine.state.opt_state.get(slot)
    if cur is not None and getattr(engine, ok, None) == id(opt):
        return cur
    if cur is None or not state_like(cur, opt.init(meta_like(template))):
        cur = engine.state.opt_state[slot] = opt.init(template)
    setattr(engine, ok, id(opt))
    return cur


def server_opt_state(engine, template) -> Any:
    """The persistent full-server-branch optimizer state, initialized on
    first use (and re-initialized if it does not fit the engine's
    optimizer, e.g. a checkpoint of another optimizer)."""
    return valid_opt_state(engine, engine.optimizer, template)


def slice_server_opt(state, template, sname: str, d: int):
    """The depth-``d`` cohort's slice of the full-branch state: moment
    stack rows ``[d:]``, non-stack moments and bookkeeping whole."""
    def sl(tree):
        out = {k: v for k, v in tree.items() if k != sname}
        out[sname] = tree_map(lambda x: x[d:], tree[sname])
        return out
    return map_moments(sl, state, template)


def cohort_server_opt(engine, cfg, sname: str, d: int):
    """Fetch the persistent full-branch state and slice this cohort's
    depth-``d`` view. Returns ``(srv_template, srv_full, srv_state)``."""
    srv_template = SN.split_params(cfg, engine.state.params, 0)[1]
    srv_full = server_opt_state(engine, srv_template)
    return (srv_template, srv_full,
            slice_server_opt(srv_full, srv_template, sname, d))


def merge_server_opt(full, cohort, template, sname: str, d: int):
    """Write a cohort's post-update server slice back into the full-branch
    state: stack moment rows ``[d:]`` are replaced; non-stack moments and
    bookkeeping (step counters) take the cohort's values."""
    if not isinstance(full, dict):
        return full
    pdef = tree_structure(template)
    out = {}
    for k, v in full.items():
        cv = cohort[k]
        if tree_structure(v) == pdef:
            merged = {kk: vv for kk, vv in cv.items() if kk != sname}
            merged[sname] = tree_map(lambda f, c: torch.cat([f[:d], c], 0),
                                     v[sname], cv[sname])
            out[k] = merged
        else:
            out[k] = cv
    return out


def broadcast_server_opt(state, n: int):
    """One copy of a server opt-state slice per client (SplitFed trains
    per-client server copies; each starts the round from the shared
    fed-averaged moments). The copies share tensors: the optimizers build
    new tensors and never write a state in place."""
    return [dict(state) if isinstance(state, dict) else state
            for _ in range(n)]


def mean_server_opt(states, start, template, n: int, src: int, mesh):
    """Collapse per-client server states back to the shared one (the
    moment-space analogue of SplitFed's FedAvg over server copies): each
    moment entry is the fp32 mean over the copies, cast back to its
    dtype; bookkeeping entries, equal in every copy, come from one copy.
    ``states`` are this rank's copies (on a fleet mesh maybe none),
    ``start`` the state they all started from, ``n`` the copies on every
    rank together and ``src`` a rank whose copies carry the live
    bookkeeping (that of a client that reached the server). Each moment's
    fp32 sum over the rank's copies is all-reduced, then divided by
    ``n``; the bookkeeping is broadcast from ``src``."""
    if not isinstance(start, dict):
        return start
    pdef = tree_structure(template)
    moments = [k for k, v in start.items() if tree_structure(v) == pdef]
    sums = {k: (tree_map(lambda *xs: torch.stack([x.float() for x in xs])
                         .sum(0), *[s[k] for s in states]) if states else
                tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                         start[k]))
            for k in moments}
    sums = SH.fleet_sum_tree(sums, mesh)
    book = SH.fleet_broadcast(
        {k: (states[0] if states else start)[k].clone()
         for k in start if k not in moments}, src, mesh)
    return {k: (tree_map(lambda t, x: (t / float(n)).to(x.dtype), sums[k],
                         start[k]) if k in sums else book[k])
            for k in start}


# ----------------------------------------------------------------- registry

_REGISTRY: Dict[str, Type[Strategy]] = {}


def register_strategy(name: str):
    def deco(cls: Type[Strategy]) -> Type[Strategy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> Strategy:
    if name not in _REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"available: {available_strategies()}")
    return _REGISTRY[name]()


def available_strategies():
    return sorted(_REGISTRY)
