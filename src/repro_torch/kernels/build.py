"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` compiles on first use into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/repro_torch/`` at the root of the checkout.
The library's file name carries a hash of its source, of every shared
header ``csrc/*.cuh`` and of the flags, so an edited source or header
never loads a stale build. ``build()`` starts one ``nvcc``
per source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module, and
a machine without ``nvcc`` only fails when a kernel is actually needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("tpgf_fusion", "layer_aggregate", "flash_attention",
                  "ssd_scan")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built here")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, *,
          ptxas_verbose: bool = False) -> Dict[str, Dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: {"seconds", "log", "cached"}}``; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    out: Dict[str, Dict] = {}
    failed = []
    try:
        for name in names:
            path = library_path(name)
            if path.exists():
                out[name] = {"seconds": 0.0, "log": "", "cached": True}
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose
                                        else ()),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, path, time.perf_counter())
        for name, (proc, tmp, path, t0) in procs.items():
            log, _ = proc.communicate()
            out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                         "cached": False}
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, path)
    finally:
        # an exception (or an interrupt) part-way leaves no nvcc behind
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
