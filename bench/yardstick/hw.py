"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates from NVIDIA's
data sheet at the 700 W power limit.

Frozen copy of ``HW`` in ``src/repro_torch/roofline/analysis.py`` at
commit c407b0fb230f1fbd6f630de9d44e64d45a4e7d44. A card set below 700 W
runs slower under load, so every share of these peaks is printed beside
the card's power limit.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}      # fp32: outside the tensor cores
HBM_BW = 3.35e12                     # bytes/s
HBM_BYTES = 80e9


def peak(dtype: str) -> float:
    """Peak FLOP/s for a dtype name ("bfloat16", "float32", ...)."""
    return PEAK_FLOPS[str(dtype).replace("torch.", "")]


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time (s) the card could take: bytes over the memory rate
    or operations over the dtype's peak, whichever is larger."""
    return max(nbytes / HBM_BW, flops / peak(dtype))
