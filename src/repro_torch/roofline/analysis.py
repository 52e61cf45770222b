"""The H100 cost model: model FLOPs, kernel bounds and roofline terms.

The counterpart of the JAX package's ``roofline/analysis.py``, whose
``HW`` holds TPU v5e figures and whose FLOP and byte counts parse XLA
HLO. Here:

* ``HW``: one H100 SXM, dense rates from NVIDIA's data sheet at the
  700 W limit. A card set below it runs slower under load, so a share
  of peak stands beside the card's power limit. There is no
  interconnect term until the port runs on more than one card.
* ``model_flops`` / ``active_params``: the reference's 6·N·D (train) and
  2·N·D (inference) rule, N the active parameters of a mixture.
* ``bound`` and one ``*_work`` function per hand-written kernel: the
  bytes the kernel must move (each input read once, each output written
  once) and the operations it must do, at a given shape. ``bound`` takes
  the larger of bytes over the memory rate and operations over the peak
  of their type: the least time the card could take.
* ``count_flops``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions
  and attention, as the reference's ``dot_flops`` counts XLA's dots).
* ``roofline_terms``: compute and memory time of a FLOP and byte count.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple


class HW:
    """One NVIDIA H100 SXM (80 GB HBM3), dense rates, 700 W limit."""
    PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                  "float32": 67e12}      # fp32: outside the tensor cores
    HBM_BW = 3.35e12                     # bytes/s
    HBM_BYTES = 80e9

    @classmethod
    def peak(cls, dtype) -> float:
        """Peak FLOP/s for a torch dtype or its name ("bfloat16", ...)."""
        return cls.PEAK_FLOPS[str(dtype).replace("torch.", "")]


def model_flops(cfg, shape, n_params: int, n_active_params: int) -> float:
    """6 N D (train) / 2 N D (inference); N = active params for MoE."""
    if cfg.family == "vlm":
        tokens = shape.global_batch * shape.seq_len
    elif cfg.is_encdec:
        tokens = shape.global_batch * (shape.seq_len + cfg.enc_frames)
    else:
        tokens = shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        tokens = shape.global_batch * 1
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active_params * tokens


def active_params(cfg, n_params: int) -> int:
    if cfg.n_experts and cfg.top_k:
        # expert weights used per token: top_k / n_experts of expert params
        # expert params dominate; approximate by scaling the MoE share
        expert_share = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
        dense_rest = n_params - expert_share
        return int(dense_rest + expert_share * cfg.top_k / cfg.n_experts)
    return n_params


def bound(nbytes: float, flops: float, peak_flops_per_s: float
          ) -> Tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory
    rate vs operations over ``peak_flops_per_s``, whichever is larger,
    and which of the two it is ("bytes" or "operations")."""
    t_bytes = nbytes / HW.HBM_BW * 1e3
    t_ops = flops / peak_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------- per-kernel (bytes, operations)

def fuse_work(n: int, itemsize: int = 4) -> Tuple[float, float]:
    """``fuse`` (TPGF Eq. 4) over ``n`` elements: a and b read, the output
    written; w·a + (1 − w)·b with the clip scale, 4 operations each."""
    return 3.0 * itemsize * n, 4.0 * n


def aggregate_work(n_clients: int, n_layers: int, feat: int
                   ) -> Tuple[float, float]:
    """``aggregate`` (Eq. 8), fp32: the client stack [N, L, F] and the
    weights [N, L] read, the server rows [L, F] read and written; a
    multiply-add per client element and three operations per output."""
    N, L, F = n_clients, n_layers, feat
    return (4.0 * N * L * F + 8.0 * L * F + 4.0 * N * L,
            2.0 * N * L * F + 3.0 * L * F)


def tier_sum_work(n_tiers: int, n: int) -> Tuple[float, float]:
    """``tier_sum``, fp32: T leaves of ``n`` read, one written; T products
    and T − 1 sums per element."""
    return 4.0 * (n_tiers + 1) * n, (2.0 * n_tiers - 1) * n


def sumsq_work(n: int) -> Tuple[float, float]:
    """``sumsq``, fp32: ``n`` elements read, a square and a sum each."""
    return 4.0 * n, 2.0 * n


def attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the masks leave, summed over the rows."""
    total = 0
    for r in range(Sq):
        hi = min(r, Skv - 1) if causal else Skv - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_work(B: int, S: int, H: int, K: int, hd: int, window: int = 0,
               itemsize: int = 2) -> Tuple[float, float]:
    """``flash_attention``, causal self-attention over S positions: q
    [B, S, H, hd], k and v [B, S, K, hd] read, the output (q's shape)
    written; two products of hd multiply-adds per attended pair and head
    (the masks' pairs only)."""
    q, kv = B * S * H * hd, B * S * K * hd
    flops = 4.0 * hd * B * H * attended_pairs(S, S, True, window)
    return float(itemsize) * (2 * q + 2 * kv), flops


# the chunk at which ssd_work counts the chunked form's own terms: fixed,
# so the yardstick does not move with the kernel's own chunk
SSD_BOUND_CHUNK = 32


def ssd_work(Bt: int, S: int, nh: int, hd: int, st: int,
             cl: int = SSD_BOUND_CHUNK) -> Tuple[float, float]:
    """(bytes, operations) of the SSD scan: the least work the function
    needs, the two state contractions (C·hᵀ and the state update, 2·hd·st
    each per row and head), plus the chunked form's own terms at a chunk
    ``cl`` (fixed at SSD_BOUND_CHUNK, whatever the kernel's own chunk): the
    causal half of W·u, cl²·hd per (batch, head, chunk), and C·Bᵀ,
    2·cl²·st per (batch, chunk). Bytes: x and y once each, B, C, dt, A, D
    and h, fp32."""
    nc = math.ceil(S / cl)
    flops = (4.0 * Bt * S * nh * hd * st + Bt * nh * nc * cl * cl * hd
             + Bt * nc * 2.0 * cl * cl * st)
    nbytes = 4.0 * (2 * Bt * S * nh * hd + 2 * Bt * S * st + Bt * S * nh
                    + 2 * nh + Bt * nh * hd * st)
    return nbytes, flops


# ------------------------------------------------------------- step counts

def count_flops(fn, *args, **kwargs) -> Tuple[float, object]:
    """``(FLOPs, result)`` of ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` over every op the call dispatches (its backward
    included): matmuls, convolutions and attention, 2 FLOPs a
    multiply-add. The counterpart of the reference's ``dot_flops``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def roofline_terms(flops: float, nbytes: float, dtype) -> Dict[str, object]:
    """Compute time at ``dtype``'s peak and memory time at the HBM rate,
    and which of the two dominates."""
    t_compute = flops / HW.peak(dtype)
    t_memory = nbytes / HW.HBM_BW
    return {"flops": flops, "bytes": nbytes,
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "dominant": "compute" if t_compute >= t_memory else "memory"}


def mfu(flops: float, wall_s: float, dtype) -> float:
    """Model FLOPs utilisation: ``flops`` over ``wall_s`` at ``dtype``'s
    peak."""
    return flops / (wall_s * HW.peak(dtype))
