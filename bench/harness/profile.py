"""The traced stretch: ``torch.profiler`` over whole rounds or steps, and
its reduction to what the per-layer metrics read.

Device operations are the profiler's device events (kernels, copies,
sets); spans are the benchmark's own (``harness.spans``), placed on the
device's clock by their marker kernels. Times are ns.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

@dataclasses.dataclass
class Profile:
    kernels: List[Tuple[str, int, int]]      # (name, start ns, duration ns)
    spans: List[Tuple[str, int, int]]        # (name, start ns, end ns)
    start_ns: int                            # the stretch, on the host
    end_ns: int
    units: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device intervals inside the stretch."""
        iv = sorted((max(s, self.start_ns), min(s + d, self.end_ns))
                    for _, s, d in self.kernels)
        out: List[Tuple[int, int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_time_s(self, patterns) -> float:
        """Device seconds of the operations whose names hold any of
        ``patterns``."""
        return sum(d for n, _, d in self.kernels
                   if any(p in n for p in patterns)) / 1e9

    def by_name(self) -> List[Tuple[str, float]]:
        tot: Dict[str, int] = {}
        for n, _, d in self.kernels:
            tot[n] = tot.get(n, 0) + d
        return sorted(((n, v / 1e9) for n, v in tot.items()),
                      key=lambda kv: -kv[1])

    def gaps(self) -> List[Tuple[str, float]]:
        """Each idle stretch of the device inside the traced window,
        named by the innermost benchmark span the host was in when it
        began (spans nest, so a stack sweep finds it)."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] \
            + [self.end_ns]
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        stack: List[Tuple[str, int, int]] = []
        i, out = 0, []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            while i < len(spans) and spans[i][1] <= a:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] <= a:
                stack.pop()
            name = stack[-1][0] if stack else "outside the benchmark's spans"
            out.append((name, (b - a) / 1e9))
        return out

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        idle: Dict[str, float] = {}
        for name, sec in self.gaps():
            idle[name] = idle.get(name, 0.0) + sec
        return {"device_ops": [[k[:200], v] for k, v in self.by_name()[:n]],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:n]]}


def capture(prof, spans, stretch: str, host_s: float) -> Profile:
    """Reduce a finished ``torch.profiler.profile`` of the device to a
    ``Profile``. ``spans`` (``harness.spans.Spans``) placed marker
    kernels at its spans' ends; they give the spans on the device's clock
    and are left out of the device operations, as is any operation that
    starts outside the stretch. The stretch is the span ``stretch``; without a device (a CPU run) it is ``host_s`` long and
    holds no operation."""
    from harness.spans import MARKER
    kernels, markers = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU" or e.is_user_annotation():
            continue
        if MARKER in e.name():
            markers.append(e.start_ns())
        else:
            kernels.append((e.name(), e.start_ns(), e.duration_ns()))
    if not spans.cuda:
        return Profile(kernels, [], 0, int(host_s * 1e9))
    on_dev = spans.on_device(sorted(markers))
    whole = [s for s in on_dev if s[0] == stretch]
    if len(whole) != 1:
        raise RuntimeError(f"the trace holds {len(whole)} {stretch!r} spans")
    _, t0, t1 = whole[0]
    return Profile([k for k in kernels if t0 <= k[1] <= t1],
                   [s for s in on_dev if s[0] != stretch], t0, t1)
