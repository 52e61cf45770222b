"""Resource-aware subnetwork allocation — paper Eq. (1) / Algorithm 1.

    d_i = min( floor(alpha * m_i)
             + floor(beta * (lat_max - lat_i) / (lat_max - lat_min + eps)),
             L - 1 ),   d_i >= 1

alpha = 0.5 layers/GB, beta = 4 (paper defaults). Profiles are reported
once at initialization (paper §II-A). The arithmetic is float32, as the
reference's, so a floor lands on the same side of an integer.
``allocate_widths`` snaps memory budgets onto a supernet width ladder.
``co_tune`` is the HASFL joint (depth, batch[, width]) solve over the
cost model of ``estimate_step_time_s``; both are host numpy, the
reference's arithmetic, so they return the reference's fleets exactly.
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


def estimate_step_time_s(d, b, mem_gb, lat_ms, client_params_by_depth,
                         tokens_per_sample: int, bytes_per_sample: int, *,
                         gflops_per_mem: float = 1.25,
                         bandwidth_mb_s: float = 20.0):
    """Per-local-step wall time of a depth-``d`` / batch-``b`` client under
    the linear device model of ``federated.metrics.DeviceModel``: 6ND
    training FLOPs on the client prefix, plus the smashed-activation round
    trip (2 messages). Vectorizes over any broadcastable d/b/mem/lat."""
    d = np.asarray(d)
    flops = 6.0 * client_params_by_depth[d] * tokens_per_sample \
        * np.asarray(b, float)
    compute = flops / (gflops_per_mem * np.asarray(mem_gb, float) * 1e9)
    comm = (2.0 * bytes_per_sample * np.asarray(b, float)
            / (bandwidth_mb_s * 1024 * 1024)
            + 2.0 * np.asarray(lat_ms, float) / 1e3)
    return compute + comm


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


def co_tune(capacity, mem_gb, lat_ms, client_params_by_depth,
            tokens_per_sample: int, bytes_per_sample: int, *,
            batch_choices=(4, 8, 16, 32), base_batch: int = 16,
            time_budget_factor: float = 1.0,
            gflops_per_mem: float = 1.25, bandwidth_mb_s: float = 20.0,
            width_tiers=None):
    """HASFL-style joint split-depth / batch-size tuning (Lin et al.).

    Per client, the largest batch and, at that batch, the deepest split
    (never above the Eq. 1 ``capacity``) whose estimated step time stays
    within the deadline: ``time_budget_factor`` x the fleet-median step
    time at (capacity, ``base_batch``). The floor (d=1, smallest batch) is
    always feasible. ``client_params_by_depth[d]`` is the client prefix's
    parameter count at depth ``d``. Returns int32 ``(depths, batches)``
    [N]; with ``width_tiers`` also ``widths`` [N] float64: the widest tier
    whose width-scaled prefix still meets the deadline at the chosen
    (d, b), the narrowest tier being the floor.
    """
    capacity = np.asarray(capacity, int)
    mem_gb = np.asarray(mem_gb, float)
    lat_ms = np.asarray(lat_ms, float)
    choices = sorted(set(int(b) for b in batch_choices))
    if not choices:
        raise ValueError("co_tune needs at least one batch choice")
    est = lambda d, b, i, w=1.0: estimate_step_time_s(
        d, b, mem_gb[i], lat_ms[i],
        np.asarray(client_params_by_depth, float) * w,
        tokens_per_sample, bytes_per_sample,
        gflops_per_mem=gflops_per_mem, bandwidth_mb_s=bandwidth_mb_s)
    n = len(capacity)
    deadline = time_budget_factor * float(np.median(
        [est(capacity[i], base_batch, i) for i in range(n)]))
    depths = np.empty(n, np.int32)
    batches = np.empty(n, np.int32)
    for i in range(n):
        depths[i], batches[i] = 1, choices[0]      # always-feasible floor
        done = False
        for b in reversed(choices):                # largest batch first...
            for d in range(int(capacity[i]), 0, -1):   # ...then deepest
                if est(d, b, i) <= deadline:
                    depths[i], batches[i] = d, b
                    done = True
                    break
            if done:
                break
    if width_tiers is None:
        return depths, batches
    tiers = sorted(float(t) for t in width_tiers)
    if not tiers or not all(0.0 < t <= 1.0 for t in tiers):
        raise ValueError(f"width tiers must be in (0, 1]: {tiers}")
    widths = np.full(n, tiers[0], np.float64)      # narrowest = the floor
    for i in range(n):
        for w in reversed(tiers):                  # widest tier that fits
            if est(depths[i], batches[i], i, w) <= deadline:
                widths[i] = w
                break
    return depths, batches, widths
