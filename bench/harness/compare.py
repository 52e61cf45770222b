"""The numbers that decide ``correct``, and their limits.

A training step is judged leaf by leaf on norms (the gap between the
program's norm of a leaf and the reference's, not the norm of their
difference), against the reference's norm of that leaf or of the median
leaf, whichever is larger, since some gradients are all but zero. Leaves
whose reference norm is under a thousandth of the median leaf's are left
out: they move by round-off alone (a key's bias under softmax, a leaf no
client trains).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

SMALL = 1e-3          # leaves under this share of the median leaf are out


def rel_gap(prog: float, ref: float) -> float:
    if not (math.isfinite(prog) and math.isfinite(ref)):
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-30)


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             only=None) -> Tuple[float, str, int]:
    """(worst gap, its leaf, leaves left out) over the leaves of ``ref``,
    or those of them for which ``only(name)`` holds (the median stays the
    median of all); a leaf the program lacks reads as gap 1."""
    med = statistics.median(ref.values())
    worst, where, out = 0.0, "", 0
    for name, r in ref.items():
        if only is not None and not only(name):
            continue
        if r < SMALL * med:
            out += 1
            continue
        p = prog.get(name)
        gap = 1.0 if p is None else (
            abs(p - r) / max(r, med) if math.isfinite(p) else math.inf)
        if gap > worst or not where:
            worst, where = gap, name
    return worst, where, out


def judge(readings: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """Every reading against its limit (``limits[name]["limit"]``); a
    reading without a limit, or a NaN, fails."""
    checks, ok = {}, True
    for name, value in readings.items():
        lim = limits.get(name, {}).get("limit")
        passed = lim is not None and math.isfinite(value) and value <= lim
        ok &= passed
        checks[name] = {"value": value, "limit": lim}
    return ok, checks
