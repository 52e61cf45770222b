"""Resource-aware subnetwork allocation — paper Eq. (1) / Algorithm 1.

    d_i = min( floor(alpha * m_i)
             + floor(beta * (lat_max - lat_i) / (lat_max - lat_min + eps)),
             L - 1 ),   d_i >= 1

alpha = 0.5 layers/GB, beta = 4 (paper defaults). Profiles are reported
once at initialization (paper §II-A). The arithmetic is float32, as the
reference's, so a floor lands on the same side of an integer.
``allocate_widths`` snaps memory budgets onto a supernet width ladder.
The HASFL co-tuning (``co_tune``) comes with a later slice of the port
(ROADMAP queue 1, "Scenario strategies").
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    mem_gb: float   # memory capacity m_i
    lat_ms: float   # round-trip smashed-data latency lat_i


def allocate_depths(mem_gb, lat_ms, n_layers: int, *, alpha: float = 0.5,
                    beta: float = 4.0, eps: float = 1e-8):
    """Vectorized Eq. (1). mem_gb, lat_ms: arrays [N]. Returns int32 [N]."""
    f32 = np.float32
    mem_gb = np.asarray(mem_gb, f32)
    lat_ms = np.asarray(lat_ms, f32)
    lat_min = lat_ms.min()
    lat_max = lat_ms.max()
    mem_term = np.floor(f32(alpha) * mem_gb)
    lat_term = np.floor(f32(beta) * (lat_max - lat_ms)
                        / (lat_max - lat_min + f32(eps)))
    d = np.minimum(mem_term + lat_term, f32(n_layers - 1))
    return np.maximum(d, f32(1)).astype(np.int32)


def sample_profiles(n_clients: int, rng: np.random.Generator,
                    *, mem_range=(2.0, 16.0), lat_range=(20.0, 200.0)):
    """The paper's heterogeneity simulator: mem ~ U[2,16] GB,
    lat ~ U[20,200] ms (§III-A)."""
    mem = rng.uniform(*mem_range, size=n_clients)
    lat = rng.uniform(*lat_range, size=n_clients)
    return [ClientProfile(float(m), float(l)) for m, l in zip(mem, lat)]


def allocate_for_profiles(profiles, n_layers: int, *, alpha: float = 0.5,
                          beta: float = 4.0, eps: float = 1e-8):
    mem = np.array([p.mem_gb for p in profiles])
    lat = np.array([p.lat_ms for p in profiles])
    return allocate_depths(mem, lat, n_layers, alpha=alpha, beta=beta,
                           eps=eps)


def allocate_widths(mem_gb, tiers, *, mem_range=(2.0, 16.0)):
    """Map client memory budgets onto a supernet width ladder ``tiers``
    (e.g. ``(0.5, 0.75, 1.0)``): each budget is placed proportionally
    within ``mem_range`` (the paper's §III-A profile range) and snapped to
    a tier, the smallest devices to the narrowest slice. Returns float64
    [N], the ``fleet.widths`` layout."""
    tiers = sorted(float(t) for t in tiers)
    if not tiers or not all(0.0 < t <= 1.0 for t in tiers):
        raise ValueError(f"width tiers must be in (0, 1]: {tiers}")
    mem = np.asarray(mem_gb, np.float64)
    lo, hi = float(mem_range[0]), float(mem_range[1])
    frac = np.clip((mem - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    idx = np.minimum((frac * len(tiers)).astype(int), len(tiers) - 1)
    return np.asarray(tiers, np.float64)[idx]
