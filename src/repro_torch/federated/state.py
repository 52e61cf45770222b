"""Explicit training state for the federated engine.

``TrainState`` carries everything a round mutates:

  params       — the global super-network tree (theta), tensors on the
                 engine's device
  local_heads  — per-client fault-tolerant classifiers phi_i (never
                 aggregated, paper §II-D) as ONE stacked tree whose leaves
                 carry a leading client axis: ``[N]`` rows, or on a fleet
                 mesh only the rows of the clients this rank owns
                 (``rows``; ``launch.sharding.fleet_owner``)
  opt_state    — cross-round optimizer state keyed by string slots; the
                 ``"server"`` slot holds the shared server branch's
                 moments over the FULL branch (see
                 ``strategies.base.server_opt_state``)
  round_idx    — completed-round counter
  fleet        — the heterogeneous device fleet (profiles, depths, cohorts)
  rng          — the numpy batch-sampling stream
  mesh         — the fleet mesh (None: one process holds every client)

Checkpoint format (``save``/``restore`` through ``repro_torch.checkpoint``,
the reference's format): one flat ``<path>.npz`` holding ``params/...``,
stacked ``local_heads/...`` leaves (leading client axis) and
``opt_state/...`` leaves, plus a ``<path>.json`` manifest with the round
counter (``step``), per-leaf dtypes and shapes and, under
``meta.batch_rng``, the batch stream's bit-generator state, so a restored
run draws the batches the uninterrupted run would have. Checkpoints from
before the stacked heads (``local_heads/<i>/...``, one subtree per
client) are detected by their all-digit keys and stacked on read. Fleet
profiles are rebuilt from the construction seed, not saved. Stateless
optimizer slots (plain SGD's ``()``) flatten to nothing and are
re-initialized after a restore.

On a fleet mesh the file is the same: ``save`` gathers every rank's head
rows (bit for bit) and rank 0 writes, then every rank waits for the
write; ``restore`` reads on every rank and keeps the rank's own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.federated.simulator import Fleet
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_map, tree_structure)

Params = Dict[str, Any]


def _cast_like(name: str, ref, new):
    """``new`` (numpy leaves) as tensors on ``ref``'s devices and in its
    dtypes; the trees must match key for key and shape for shape."""
    if tree_structure(ref) != tree_structure(new):
        raise ValueError(f"checkpoint {name} do not match this state's tree")
    bad = [p for (p, r), (_, n) in zip(tree_flatten_with_path(ref),
                                       tree_flatten_with_path(new))
           if tuple(r.shape) != tuple(np.shape(n))]
    if bad:
        raise ValueError(f"checkpoint {name}: shapes differ at {bad[:3]}")
    return tree_map(lambda r, n: torch.tensor(np.asarray(n), dtype=r.dtype,
                                              device=r.device), ref, new)


@dataclasses.dataclass
class TrainState:
    params: Params
    local_heads: Params          # stacked: every leaf is [rows, ...]
    opt_state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    round_idx: int = 0
    fleet: Fleet = None
    rng: np.random.Generator = None
    mesh: Any = None

    @property
    def n_clients(self) -> int:
        """The fleet's size (on a fleet mesh, more than the heads' rows)."""
        if self.fleet is not None:
            return int(self.fleet.n_clients)
        return int(tree_leaves(self.local_heads)[0].shape[0])

    @property
    def rows(self) -> Tuple[int, int]:
        """``(lo, hi)``: ``local_heads`` holds clients ``lo .. hi - 1``."""
        return SH.owned_range(self.n_clients, self.mesh)

    def row(self, i: int) -> int:
        """The row of ``local_heads`` that holds client ``i``."""
        lo, hi = self.rows
        if not lo <= int(i) < hi:
            raise IndexError(f"client {int(i)} lives on another rank "
                             f"(this one holds clients {lo}..{hi - 1})")
        return int(i) - lo

    def head_for(self, i: int) -> Params:
        """Client ``i``'s phi_i as an unstacked tree (views)."""
        r = self.row(i)
        return tree_map(lambda x: x[r], self.local_heads)

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str, *, meta: Dict[str, Any] = None) -> None:
        """Write ``<path>.npz`` + ``<path>.json`` (format in the module
        docstring); ``meta`` entries join the manifest's meta block
        (``Engine.save`` puts its stream states there)."""
        meta = dict(meta or {})
        if self.rng is not None:
            meta["batch_rng"] = self.rng.bit_generator.state
        heads = SH.fleet_gather(self.local_heads, self.n_clients, self.mesh)
        if SH.fleet_rank(self.mesh) == 0:
            save_checkpoint(path, {"params": self.params,
                                   "local_heads": heads,
                                   "opt_state": self.opt_state},
                            step=self.round_idx, meta=meta)
        # no rank reads the file before rank 0 has written it
        SH.fleet_barrier(self.mesh)

    def restore(self, path: str) -> "TrainState":
        """Load ``path`` into this state, in place: params and heads are
        cast onto the existing trees (their devices and dtypes), opt_state
        is adopted whole on the params' device (strategies re-validate its
        shape), and the batch stream resumes from the saved bit-generator
        state. The manifest's meta block stays on
        ``self.last_restore_meta``."""
        tree, manifest = load_checkpoint(path)
        self.last_restore_meta = manifest.get("meta", {})
        self.params = _cast_like("params", self.params, tree["params"])
        heads = tree["local_heads"]
        if heads and all(k.isdigit() for k in heads):
            # one subtree per client index: stack them
            heads = tree_map(lambda *xs: np.stack(xs),
                             *[heads[str(i)] for i in range(len(heads))])
        if SH.fleet_extent(self.mesh) > 1:
            if {np.shape(x)[0] for x in tree_leaves(heads)} \
                    != {self.n_clients}:
                raise ValueError("checkpoint local_heads do not hold "
                                 f"{self.n_clients} clients")
            lo, hi = self.rows
            heads = tree_map(lambda x: np.asarray(x)[lo:hi], heads)
        self.local_heads = _cast_like("local_heads", self.local_heads,
                                      heads)
        device = tree_leaves(self.params)[0].device
        self.opt_state = tree_map(
            lambda x: torch.tensor(np.asarray(x), device=device),
            tree.get("opt_state", {}))
        self.round_idx = int(manifest["step"])
        batch_rng = self.last_restore_meta.get("batch_rng")
        if batch_rng is not None:
            self.rng = np.random.default_rng()  # fleetlint: disable=FL004 — empty shell; state overwritten next line from the checkpoint
            self.rng.bit_generator.state = batch_rng
        return self


def init_train_state(cfg: ModelConfig, n_clients: int, *, seed: int = 0,
                     fleet: Fleet = None, device=None,
                     mesh=None) -> TrainState:
    """Fresh state on ``device`` (None: the card, see
    ``repro_torch.device.resolve_device``): global params from a
    ``torch.Generator`` seeded with ``seed``, the per-client heads phi_i
    from one seeded with ``seed + 1`` (stacked along the client axis), the
    batch stream ``np.random.default_rng(seed)`` — the reference's
    RNG-stream offsets. On a fleet ``mesh`` every rank draws the same
    params and every head, and keeps the heads of the clients it owns."""
    device = resolve_device(device)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device)
    hgen = torch.Generator().manual_seed(seed + 1)
    heads = [M.init_local_head(cfg, hgen, device) for _ in range(n_clients)]
    local_heads = SH.shard_fleet(
        tree_map(lambda *xs: torch.stack(xs), *heads), n_clients, mesh)
    return TrainState(params=params, local_heads=local_heads, fleet=fleet,
                      rng=np.random.default_rng(seed), mesh=mesh)
