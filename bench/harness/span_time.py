"""Device time inside the program's spans, from a traced run's profile.

A span's device time is the union of the intervals of the device
operations that start inside any of its occurrences (on the device's
clock, as its marker kernels place it): an operation the host queued
inside the span, wherever on the device it then ran. Spans of the
program (``repro_torch.trace``) reach the profile only when the cell's
driver records them; otherwise there is nothing to read.

A region's backward pass runs outside its span. The program marks where
the backward crosses the region's edges with the empty spans
``<region>.backward.begin`` and ``<region>.backward.end``; the region's
backward is each stretch from a begin to the next end, and its device
time the union of the operations that start inside those stretches.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def _union_inside(profile, occ) -> float:
    """Seconds of the union of the device operations that start inside
    any of the stretches ``occ`` ((start, end) ns, apart)."""
    occ = sorted(occ)
    starts = [t0 for t0, _ in occ]
    inside: List[Tuple[int, int]] = []
    for _, s, d in profile.kernels:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= occ[i][1]:
            inside.append((s, s + d))
    total, end = 0, None
    for a, b in sorted(inside):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def span_device_s(profile, name: str) -> Optional[float]:
    """Seconds of device time inside the span ``name`` over the profiled
    stretch, or None when the profile holds no such span."""
    if profile is None:
        return None
    occ = [(t0, t1) for n, t0, t1 in profile.spans if n == name]
    return _union_inside(profile, occ) if occ else None


def backward_stretches(profile, name: str) -> List[Tuple[int, int]]:
    """The stretches of the region ``name``'s backward passes: each
    ``name.backward.begin`` point to the next ``name.backward.end``."""
    marks = sorted((t0, n) for n, t0, _ in profile.spans
                   if n in (f"{name}.backward.begin",
                            f"{name}.backward.end"))
    out, begun = [], None
    for t, n in marks:
        if n.endswith(".begin"):
            begun = t
        elif begun is not None:
            out.append((begun, t))
            begun = None
    return out


def region_device_s(profile, name: str) -> Optional[float]:
    """Seconds of device time of the region ``name``: inside its span
    (its forward runs) or inside its backward's stretches; None when
    the profile holds no such span."""
    if profile is None:
        return None
    occ = [(t0, t1) for n, t0, t1 in profile.spans if n == name]
    if not occ:
        return None
    return _union_inside(profile, occ + backward_stretches(profile, name))


def per_unit_ms(ctx, name: str, read=span_device_s) -> Optional[float]:
    """``read`` (``span_device_s`` or ``region_device_s``) as ms a
    profiled unit (a step)."""
    p = ctx.profile
    sec = read(p, name)
    if sec is None or not p.units:
        return None
    return 1e3 * sec / len(p.units)
