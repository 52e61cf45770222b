#!/usr/bin/env python3
"""Times the port's ViT training rounds in one checkout, on one card.

    python3 tools/round_times_torch.py ROOT [ROOT ...]

For each checkout ROOT (a directory holding ``src/repro_torch``), in the
order given, prints one JSON line. For two strategies on the fleet of
``chip_smoke.py``'s main path (ViT-16-CIFAR at full width, fp32, the
kernels on, 8 clients, seed 0, SGD lr 0.05, 2 local steps, batch 32,
availability 0.9):

  - ``ssfl``: the main path's strategy;
  - ``unstable``: a scenario strategy (its defaults); every round trains
    other clients, the same ones in every checkout (the same seed);

it gives each round's wall time (host clock after
``torch.cuda.synchronize()``; one warm-up round, then ``ROUNDS``), their
median, the peak allocated memory, and the device's busy time in one
more round under ``torch.profiler`` (the sum of the device-side rows, as
``chip_smoke.py`` counts it) beside that round's own unprofiled wall, on
a copy of the engine. It also times the ``gelu`` that the checkout's
``mlp_apply`` runs (``layers.gelu`` where the checkout has one, else
``F.gelu(x, approximate="tanh")``) on a ViT MLP's pre-activation [32, 64,
3072] fp32 and a Whisper encoder's [16, 1500, 3072] bf16, and the fused
``F.gelu`` beside it (CUDA events, median of 5 batches of 20 calls).

Each checkout runs in a process of its own, so two versions of the port
can be compared within one call: give them in turns (parent, change,
change, parent). Needs a CUDA device; the card's name and power limit
come first.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

ROUNDS = 4
ENGINE_ARGS = dict(seed=0, lr=0.05, local_steps=2, batch_size=32,
                   availability=0.9)
GELU_SHAPES = {"vit_fp32": ((32, 64, 3072), "float32"),
               "whisper_bf16": ((16, 1500, 3072), "bfloat16")}


def _busy_ms(step) -> float:
    """Device time of one call of ``step`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")
    return sum(getattr(ev, attr, 0) for ev in averages
               if getattr(ev, attr, 0) > 0 and ev.cpu_time_total == 0) / 1e3


def _event_ms(fn, reps: int = 20, batches: int = 5) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def measure(root: str) -> dict:
    """The round and gelu times of the checkout at ``root``."""
    sys.path.insert(0, f"{root}/src")
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.federated import Engine
    from repro_torch.kernels import build as B
    from repro_torch.models import layers as L
    if not torch.cuda.is_available():
        raise SystemExit("round_times_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B.build(("tpgf_fusion", "layer_aggregate"))
    out = {"root": root}
    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    for strategy in ("ssfl", "unstable"):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, 8, strategy, device="cuda", **ENGINE_ARGS)
        walls = []
        for _ in range(ROUNDS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = eng.run_round()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{strategy}_round_ms"] = walls[1:]
        out[f"{strategy}_round_median_ms"] = statistics.median(walls[1:])
        out[f"{strategy}_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{strategy}_loss"] = float(rec["loss"])
        # the next round twice, on copies: unprofiled, then profiled
        twin = copy.deepcopy(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin.run_round()
        torch.cuda.synchronize()
        out[f"{strategy}_next_round_ms"] = (time.perf_counter() - t0) * 1e3
        del twin
        out[f"{strategy}_next_round_busy_ms"] = _busy_ms(eng.run_round)
        del eng
        torch.cuda.empty_cache()
    gelu = getattr(L, "gelu", lambda x: F.gelu(x, approximate="tanh"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (shape, dtype) in GELU_SHAPES.items():
        x = (3 * torch.randn(shape, generator=gen, device="cuda")).to(
            getattr(torch, dtype))
        out[f"gelu_{name}_ms"] = _event_ms(lambda: gelu(x))
        out[f"fused_gelu_{name}_ms"] = _event_ms(
            lambda: F.gelu(x, approximate="tanh"))
        del x
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
