"""Explicit training state for the federated engine.

``TrainState`` carries everything a round mutates:

  params       — the global super-network tree (theta), tensors on the
                 engine's device
  local_heads  — per-client fault-tolerant classifiers phi_i (never
                 aggregated, paper §II-D) as ONE stacked tree whose leaves
                 carry a leading ``[N]`` client axis
  opt_state    — cross-round optimizer state keyed by string slots; the
                 ``"server"`` slot holds the shared server branch's
                 moments over the FULL branch (see
                 ``strategies.base.server_opt_state``)
  round_idx    — completed-round counter
  fleet        — the heterogeneous device fleet (profiles, depths, cohorts)
  rng          — the numpy batch-sampling stream

Checkpoints (``save``/``restore``) come with a later slice (ROADMAP
queue 1, item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.federated.simulator import Fleet
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    params: Params
    local_heads: Params          # stacked: every leaf is [N, ...]
    opt_state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    round_idx: int = 0
    fleet: Fleet = None
    rng: np.random.Generator = None

    @property
    def n_clients(self) -> int:
        return int(tree_leaves(self.local_heads)[0].shape[0])

    def head_for(self, i: int) -> Params:
        """Client ``i``'s phi_i as an unstacked tree (views)."""
        return tree_map(lambda x: x[i], self.local_heads)


def init_train_state(cfg: ModelConfig, n_clients: int, *, seed: int = 0,
                     fleet: Fleet = None, device=None) -> TrainState:
    """Fresh state on ``device`` (None: the card, see
    ``repro_torch.device.resolve_device``): global params from a
    ``torch.Generator`` seeded with ``seed``, the per-client heads phi_i
    from one seeded with ``seed + 1`` (stacked along the client axis), the
    batch stream ``np.random.default_rng(seed)`` — the reference's
    RNG-stream offsets."""
    device = resolve_device(device)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device)
    hgen = torch.Generator().manual_seed(seed + 1)
    heads = [M.init_local_head(cfg, hgen, device) for _ in range(n_clients)]
    local_heads = tree_map(lambda *xs: torch.stack(xs), *heads)
    return TrainState(params=params, local_heads=local_heads, fleet=fleet,
                      rng=np.random.default_rng(seed))
