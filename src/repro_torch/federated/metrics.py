"""Communication-cost, wall-time, and energy accounting (the paper's Table
I/II metrics): a numpy cost model, unchanged from the reference.

Device model (defaults; configurable):
  client compute speed  ~ 1.25 GFLOP/s per GB of client memory
  server compute speed  = 200 GFLOP/s
  bandwidth             = 20 MB/s per client link
  per-message latency   = lat_i (from the client profile)
  client power          = 5 W active; server power = 250 W active
Energy = power x busy-time, CO2 = energy x 0.4 kg/kWh grid factor.
These are the simulated fleet's numbers, not the host card's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.tree import tree_leaves

MB = 1024 * 1024


@dataclasses.dataclass
class DeviceModel:
    client_gflops_per_mem: float = 1.25   # GFLOP/s per GB of memory
    server_gflops: float = 200.0
    bandwidth_mb_s: float = 20.0
    client_power_w: float = 5.0
    server_power_w: float = 250.0
    co2_kg_per_kwh: float = 0.4

    def client_speed(self, mem_gb: float) -> float:
        return self.client_gflops_per_mem * mem_gb * 1e9

    def comm_time_s(self, n_bytes: int, lat_ms: float, n_messages: int = 1
                    ) -> float:
        return n_bytes / (self.bandwidth_mb_s * MB) + n_messages * lat_ms / 1e3


@dataclasses.dataclass
class RoundStats:
    comm_bytes: int = 0
    client_flops: float = 0.0
    server_flops: float = 0.0
    round_time_s: float = 0.0       # max over clients (sync barrier)
    energy_j: float = 0.0
    n_messages: int = 0


class Accountant:
    """Accumulates per-round stats into a training-run ledger."""

    def __init__(self, device_model: DeviceModel = None):
        self.dm = device_model or DeviceModel()
        self.rounds = []

    def log_round(self, stats: RoundStats):
        self.rounds.append(stats)

    @property
    def total_comm_mb(self) -> float:
        return sum(r.comm_bytes for r in self.rounds) / MB

    @property
    def total_time_s(self) -> float:
        return sum(r.round_time_s for r in self.rounds)

    @property
    def total_energy_j(self) -> float:
        return sum(r.energy_j for r in self.rounds)

    @property
    def avg_power_w(self) -> float:
        t = self.total_time_s
        return self.total_energy_j / t if t > 0 else 0.0

    def co2_g(self) -> float:
        kwh = self.total_energy_j / 3.6e6
        return kwh * self.dm.co2_kg_per_kwh * 1000.0

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": len(self.rounds),
            "comm_mb": round(self.total_comm_mb, 2),
            "time_s": round(self.total_time_s, 2),
            "energy_j": round(self.total_energy_j, 1),
            "avg_power_w": round(self.avg_power_w, 1),
            "co2_g": round(self.co2_g(), 2),
        }


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (the wire size of a model
    download or upload)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def dense_train_flops(n_params: int, n_tokens: int) -> float:
    """6 N D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params * n_tokens
