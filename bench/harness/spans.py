"""The benchmark's spans: host time around calls into a layer, with the
device synchronised at each span's end, and, while the profiler runs,
a marker kernel at each span's start and end.

The profiler traces the device alone (CUPTI's kernel records): tracing
the host's operators as well cost the ViT rounds six times their wall on
the H100, which would make the device look idle. The markers put the
spans into the device's timeline instead: a span's end marker is
launched after the synchronisation, and the next span's start marker
into an idle device, so each marker runs when the host reaches it. The
markers' records, in launch order, pair with the host's span events,
in the same order.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

MARKER = "spin_kernel"


class Spans:
    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.totals: Dict[str, float] = {}   # host seconds, since reset
        self.events: List[Tuple[str, str]] = []   # (name, "b" or "e")
        self.marking = False

    def reset(self) -> None:
        self.totals = {}

    def _mark(self, name: str, kind: str) -> None:
        if self.marking:
            import torch
            self.events.append((name, kind))
            if self.cuda:
                torch.cuda._sleep(1)

    @contextlib.contextmanager
    def __call__(self, name: str, timed: bool = True):
        """A span named ``name``; ``timed`` adds its host time to
        ``totals``."""
        import torch
        self._mark(name, "b")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            if timed:
                self.totals[name] = self.totals.get(name, 0.0) \
                    + time.perf_counter() - t0
            self._mark(name, "e")

    def on_device(self, markers: List[int]) -> List[Tuple[str, int, int]]:
        """The spans' (name, start, end) on the device's clock, from the
        start times of the marker kernels in launch order."""
        if len(markers) != len(self.events):
            raise RuntimeError(f"{len(markers)} marker kernels traced for "
                               f"{len(self.events)} span events")
        out, open_ = [], []
        for (name, kind), t in zip(self.events, markers):
            if kind == "b":
                open_.append((name, t))
            else:
                begun, t0 = open_.pop()
                if begun != name:
                    raise RuntimeError(f"span {name} ends inside {begun}")
                out.append((name, t0, t))
        return out
