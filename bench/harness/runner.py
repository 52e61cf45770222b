"""One run of one cell: set-up, the measured window, the traced stretch
(with ``--trace 1``), the output comparison, and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``setup_s`` runs from the process's start to the first measured round
or step: imports, loading the kernels, the inputs and weights drawn on
the card, the program's state and the checked first units, which are
also the warm-up. The kernels' build with ``nvcc``, which only a
checkout's first run makes, is timed apart (``kernel_build_s``, printed
on a line of its own) and left out of ``setup_s``. The window then runs
whole units until ``--seconds`` have passed and finishes the one in
flight; a rate is the window's work over the window's time. With ``--trace 1`` the driver
times its spans (synchronising at each span's end) over the window, and
``torch.profiler`` then traces ``profile_units`` more whole units; the
per-layer metrics are read over the window and that stretch together.
After the window the program's state is freed, the memory peak read,
and the plain reference run on the same inputs; each number it compares
is printed beside its limit, last on standard error and last in the
result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from harness import compare
from harness.spans import Spans
from harness.spec import ROOT, Cell, driver_module, load_cell, metric_module

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader sees."""
    cell: str
    config: Dict
    traffic: Dict
    units: List[Dict]              # every unit of the traced run's window
    window_s: float
    profile: Optional[object]      # harness.profile.Profile, or None


class KernelBuilds:
    """Times every build of the program's CUDA kernels
    (``repro_torch.kernels.build.build``, which runs ``nvcc`` for each
    library not yet in the checkout's ``build/``) while it is entered."""

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        from repro_torch.kernels import build as kb
        self._mod, self._build = kb, kb.build

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return self._build(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t
        kb.build = timed
        return self

    def __exit__(self, *exc):
        self._mod.build = self._build
        return False


def card() -> Dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", "-i", "0"], capture_output=True, text=True,
            timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> Dict:
    """Drive one run of ``cell``; returns the result object (without the
    card's description) plus ``info`` lines. ``t_start`` is the process's
    start on ``time.perf_counter``'s clock."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    if cuda:
        # the configurations state fp32 products without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans(device) if trace else None
    with KernelBuilds() as builds:
        drv = driver_module(cell).Driver(cell, seed, device, spans)
        sync()
    setup_s = time.perf_counter() - t_start - builds.seconds
    log(f"# kernel build {builds.seconds:.3f} s, left out of set-up")
    log(f"# set-up {setup_s:.3f} s")

    units: List[Dict] = []
    attempted = failed = 0
    t0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            rec = drv.run_unit()
        except Exception as exc:           # a unit that raises is failed
            log(f"# {drv.UNIT} {attempted} raised {exc!r}")
            failed += 1
            break
        units.append(rec)
        log(f"# {drv.UNIT} {attempted} ends at "
            f"{time.perf_counter() - t0:.3f} s")
        if time.perf_counter() - t0 >= seconds:
            break
    failed += drv.end_window(units)
    sync()
    t1 = time.perf_counter()

    prof, overhead = None, None
    if trace and not failed:
        from torch.profiler import ProfilerActivity, profile

        from harness.profile import capture
        traced = []
        if cuda:
            # every marker must reach the trace, and the profiler has been
            # seen to miss the first kernel it runs: the marker's kernel
            # is loaded before the trace, and an unmarked one leads it
            torch.cuda._sleep(1)
            sync()
        spans.events, spans.marking = [], True
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as p:
            if cuda:
                torch.ones(1, device=device).add_(1)
                sync()
            with spans("profiled", timed=False):
                for _ in range(drv.PROFILE_UNITS):
                    attempted += 1
                    with spans(drv.UNIT, timed=False):
                        traced.append(drv.run_unit())
                failed += drv.end_window(traced)
        spans.marking = False
        t2 = time.perf_counter()
        prof = capture(p, spans, "profiled", t2 - t1)
        prof.units = traced
        del p
        rate_w = sum(u["work"] for u in units) / (t1 - t0)
        rate_p = sum(u["work"] for u in traced) / (t2 - t1)
        overhead = (f"# tracing overhead: {rate_w:.4f} {drv.WORK} per s over "
                    f"the window, {rate_p:.4f} under the profiler "
                    f"({rate_w / rate_p - 1:+.2%})")
        log(overhead)
        units = units + traced
        t1 = t2
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    found = forbidden_modules()
    drv.release()
    readings = drv.check()
    ok, checks = compare.judge(readings, cell.limits)
    correct = bool(ok and failed == 0 and attempted > 0)

    metrics: Dict[str, Dict] = {}
    if not trace:
        rate = sum(u["work"] for u in units) / window_s
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else (
                rate if m["name"] == drv.RATE_METRIC else None)
            if value is None:
                raise KeyError(f"driver {cell.traffic['driver']} reports no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = MetricContext(cell.name, cell.config, cell.traffic, units,
                            window_s, prof)
        for m in cell.per_layer:
            value = metric_module(cell, m).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"count": cell.chips, "memory_peak_bytes": peak}}
    if prof is not None:
        result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = prof.breakdown()
    result["checks"] = checks
    result["info"] = {"setup_s": setup_s, "window_s": window_s,
                      "kernel_build_s": builds.seconds,
                      "units": len(units), "forbidden": found,
                      "profile": prof, "overhead": overhead}
    return result


def main(argv=None, t_start: float = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--benchmark", default=str(ROOT / "BENCHMARK.json"),
                    help="the BENCHMARK.json whose cell to run")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be 0 or more")
    cell = load_cell(Path(args.benchmark), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    info = res.pop("info")
    found = sorted(set(info["forbidden"]) | set(forbidden_modules()))
    if found:
        print("bench: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    dev = card()
    res["device"] = {**dev, **res["device"]}
    print(f"# card {dev['kind']}, power limit {dev['power_limit_w']} W")
    print(f"# memory peak {res['device']['memory_peak_bytes']} bytes "
          "(torch.cuda.max_memory_allocated)")
    print(f"# kernel build {info['kernel_build_s']:.3f} s (nvcc, a "
          "checkout's first run only; not in setup_s)")
    print(f"# set-up {info['setup_s']:.3f} s, window {info['window_s']:.3f} s"
          f", {info['units']} units")
    if info["profile"] is not None:
        path = write_trace(args, info["profile"])
        print(f"# trace summary {path}")
        print(info["overhead"])
    checks = res["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0


def write_trace(args, prof) -> Path:
    """A small summary of the traced stretch: device time by operation
    and idle time by span (the full trace would be hundreds of MB)."""
    out = ROOT / "build" / "bench"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace-{args.workload}-{args.seed}.json"
    gaps = prof.gaps()
    with open(path, "w") as f:
        json.dump({"window_s": prof.window_s, "busy_s": prof.busy_s,
                   "device_ops": prof.by_name()[:200],
                   "idle_by_span": prof.breakdown(50)["idle_gaps"],
                   "longest_gaps": sorted(gaps, key=lambda g: -g[1])[:50],
                   "n_device_ops": len(prof.kernels),
                   "n_gaps": len(gaps)}, f)
    return path


if __name__ == "__main__":
    raise SystemExit(main())

