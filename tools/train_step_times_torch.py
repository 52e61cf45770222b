#!/usr/bin/env python3
"""Times the port's LM training steps in one checkout, on one card.

    python3 tools/train_step_times_torch.py ROOT [ROOT ...]

For each checkout ROOT (a directory holding ``src/repro_torch``), in the
order given, prints one JSON line: the wall time of a training step
(host clock after ``torch.cuda.synchronize()``, the median of 3 steps
after one warm-up step), tokens/s and peak allocated memory, for the two
LM training paths of ``chip_smoke.py`` at full width and depth, on 8 × 512
tokens of ``synthetic_lm_batches`` and weights drawn on the card from
seed 0:

  - ``mamba2``: Mamba2-2.7B through ``launch.steps.make_train_step`` with
    its config (bf16, remat, 4 microbatches, AdamW with fp32 moments) and
    the kernels on;
  - ``llama``: Llama-3.2-3B with ``launch/train.py``'s config (one
    microbatch) and ``adamw(1e-3)``, the kernels off.

Each checkout runs in a process of its own, so two versions of the port
can be compared within one call: give them in turns (parent, change,
change, parent). Needs a CUDA device; the card's name and power limit
come first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

BATCH, SEQ, STEPS = 8, 512, 3


def measure(root: str) -> dict:
    """The step times of the checkout at ``root``."""
    sys.path.insert(0, f"{root}/src")
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import synthetic_lm_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    if not torch.cuda.is_available():
        raise SystemExit("train_step_times_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    paths = {"mamba2": (get_config("mamba2_2_7b").replace(use_pallas=True),
                        None),
             "llama": (train_config("llama3_2_3b", reduced=False),
                       adamw(1e-3))}
    for name, (cfg, opt) in paths.items():
        step, opt = make_train_step(cfg, opt)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        state = opt.init(params)
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                    b.items()} for b in synthetic_lm_batches(
                        cfg.vocab, SEQ, BATCH, STEPS + 1, seed=1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for b in batches:
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls[1:])
        out[f"{name}_step_ms"] = wall * 1e3
        out[f"{name}_tokens_per_s"] = BATCH * SEQ / wall
        out[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{name}_loss_server"] = float(metrics["loss_server"])
        del params, state, step, opt, batches, metrics
        torch.cuda.empty_cache()
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
