"""Heterogeneous-fleet simulation state (profiles, depths, width tiers,
cohorts); numpy only, unchanged from the reference."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import allocation as AL


@dataclasses.dataclass
class Fleet:
    profiles: List[AL.ClientProfile]
    depths: np.ndarray            # [N] int — allocated subnetwork depths
    capacity: np.ndarray = None   # [N] int — Eq.1 depth the device CAN host
    feasible: np.ndarray = None   # [N] bool — depths[i] <= capacity[i]
    widths: np.ndarray = None     # [N] float — supernet width tier in (0, 1]

    def __post_init__(self):
        if self.capacity is None:
            self.capacity = self.depths.copy()
        if self.feasible is None:
            # a rigid split deeper than the device's Eq.1 capacity cannot
            # be hosted — that client cannot participate
            self.feasible = self.depths <= self.capacity
        if self.widths is None:
            # full width: every cohort is one width group
            self.widths = np.ones(len(self.profiles), np.float64)

    @property
    def n_clients(self) -> int:
        return len(self.profiles)

    def cohorts(self) -> Dict[int, np.ndarray]:
        """Group FEASIBLE client ids by depth, in ascending depth order."""
        out: Dict[int, np.ndarray] = {}
        for d in sorted(set(self.depths.tolist())):
            ids = np.where((self.depths == d) & self.feasible)[0]
            if len(ids):
                out[int(d)] = ids
        return out


def make_fleet(cfg: ModelConfig, n_clients: int, *, seed: int = 0,
               fixed_depth: int = None, mem_range=(2.0, 16.0),
               lat_range=(20.0, 200.0)) -> Fleet:
    rng = np.random.default_rng(seed)
    profiles = AL.sample_profiles(n_clients, rng, mem_range=mem_range,
                                  lat_range=lat_range)
    capacity = AL.allocate_for_profiles(
        profiles, cfg.split_stack_len,
        alpha=cfg.alloc_alpha, beta=cfg.alloc_beta)
    capacity = np.minimum(capacity, cfg.split_stack_len - 1).astype(np.int32)
    if fixed_depth is not None:   # SFL baseline: one split point for everyone
        depths = np.full(n_clients, fixed_depth, np.int32)
    else:
        depths = capacity.copy()
    return Fleet(profiles, depths, capacity)
