"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The program under test is the PyTorch
and CUDA package under ``src/``; its kernels build into ``build/`` of the
checkout on a cell's first run there, and every other cache of the run
(PyTorch's extensions, Triton's, CUDA's) is kept under ``build/`` too,
at fixed paths, so a later run finds it.
"""
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
# one process with few threads: the host's other cores stay free for the
# CUDA driver and whatever else shares the machine
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness.runner import main, process_age_s  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=time.perf_counter() - process_age_s()))
