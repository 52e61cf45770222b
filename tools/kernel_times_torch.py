#!/usr/bin/env python3
"""Times the port's two serving kernels in one checkout, on one card.

    python3 tools/kernel_times_torch.py ROOT [ROOT ...]

For each checkout ROOT (a directory holding ``src/repro_torch``), in the
order given, builds its ``flash_attention`` and ``ssd_scan`` and prints one
JSON line of device times (ms a call: CUDA events around 20 back-to-back
calls, the median of 5 runs, after 3 warm-up calls) at the serving paths'
shapes: ``flash_attention`` bf16 causal at Llama-3.2-3B's prefill (q
[4, 2048, 24, 128], K 8) and Hymba-1.5B's (q [4, 2048, 25, 64], K 5),
each beside ``F.scaled_dot_product_attention``; ``ssd_scan`` at
Mamba2-2.7B's (x [4, 2048, 80, 64], st 128) and Hymba-1.5B's (nh 50,
st 16). Each checkout runs in a process of its own, so two versions of
the port can be compared within one call: give them in turns (parent,
change, change, parent). Needs a CUDA device; the card's name and power
limit come first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

FLASH = {"llama": (4, 2048, 24, 8, 128), "hymba": (4, 2048, 25, 5, 64)}
SCAN = {"mamba2": (4, 2048, 80, 64, 128), "hymba": (4, 2048, 50, 64, 16)}


def time_ms(fn, warmup: int = 3, reps: int = 20, samples: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / reps)
    return statistics.median(runs)


def measure(root: str) -> dict:
    """The times of the kernels of the checkout at ``root``."""
    sys.path.insert(0, f"{root}/src")
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.ssd_scan import ops as SO
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times_torch: needs a CUDA device")
    build.build(("flash_attention", "ssd_scan"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    with torch.no_grad():
        for name, (b, s, h, k, d) in FLASH.items():
            q = torch.randn((b, s, h, d), generator=gen,
                            device="cuda").bfloat16()
            kk = torch.randn((b, s, k, d), generator=gen,
                             device="cuda").bfloat16()
            v = torch.randn((b, s, k, d), generator=gen,
                            device="cuda").bfloat16()
            out[f"flash_{name}_ms"] = time_ms(
                lambda: FO.flash_attention(q, kk, v, causal=True))
            out[f"sdpa_{name}_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True))
        for name, (b, s, nh, hd, st) in SCAN.items():
            x = torch.randn((b, s, nh, hd), generator=gen, device="cuda")
            dt = 0.01 + 0.19 * torch.rand((b, s, nh), generator=gen,
                                          device="cuda")
            A = -torch.linspace(1.0, 16.0, nh, device="cuda")
            Bm = torch.randn((b, s, st), generator=gen, device="cuda")
            C = torch.randn((b, s, st), generator=gen, device="cuda")
            D = torch.randn((nh,), generator=gen, device="cuda")
            out[f"ssd_{name}_ms"] = time_ms(
                lambda: SO.ssd_scan(x, dt, A, Bm, C, D))
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
