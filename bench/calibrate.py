"""Readings that the limits of a cell's output comparison are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control 1 2 3] [--faults half_batch label] [--out FILE]

For each seed, in one process: the cell's set-up and checked units (no
window), the program's state freed, then the plain reference; one JSON
line with the numbers the run would compare (the program against the
reference: the lower readings). For each ``--control`` seed also the
reference computed in the precision below the configuration's (TF32
operands for fp32, fp8 for bf16) put in the program's place, and each
``--faults`` fault planted in the reference put in the program's place:
the upper readings. Needs the card, as a run does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from harness.spec import ROOT, driver_module, load_cell  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell, seeds, control=(), faults=(), device="cuda",
             detail=False):
    """Yield one dict per (seed, kind) as the module docstring says; with
    ``detail`` each also holds both sides' outputs whole."""
    import torch
    Driver = driver_module(cell).Driver
    low = CONTROL[cell.config["dtype"]]
    for seed in dict.fromkeys(list(seeds) + list(control)):
        t0 = time.perf_counter()
        drv = Driver(cell, seed, device, None)
        drv.release()
        prog = drv.program()
        ref = drv.reference("fp32")
        rows = []
        if seed in seeds:
            rows.append(("program", prog))
        if seed in control:
            rows.append((f"control_{low}", drv.reference(low)))
            for fault in faults:
                rows.append((f"fault_{fault}", drv.reference("fp32", fault)))
        for kind, out in rows:
            row = {"cell": cell.name, "seed": seed, "kind": kind,
                   "readings": drv.compare(out, ref),
                   "seconds": time.perf_counter() - t0}
            if detail:
                row.update(outputs=out, reference=ref)
            yield row
        del drv, prog, ref
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--detail", action="store_true",
                    help="keep both sides' outputs in each line")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(ROOT / "BENCHMARK.json", args.workload)
    out = open(args.out, "a") if args.out else None
    for row in readings(cell, args.seeds, args.control, args.faults,
                        detail=args.detail):
        line = json.dumps(row, default=lambda o: o.tolist()
                          if hasattr(o, "tolist") else str(o))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
