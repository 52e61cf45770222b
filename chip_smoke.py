#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, one JSON line each (plus the card's name and power limit as
``nvidia-smi`` prints them):

  1. environment — card, power limit, torch and CUDA versions; TF32 off;
  2. build — every CUDA kernel of the port, one ``nvcc`` per source, all
     started together, from ``src/repro_torch/csrc``;
  3. kernels — each kernel's wrapper against its plain PyTorch version on
     the card at the main path's shapes (and ragged, unaligned and bf16
     cases), with times from CUDA events: kernel, plain version, one
     PyTorch library call where one computes the same function, and the
     bound (bytes over 3.35 TB/s vs operations over 67 TFLOP/s fp32);
  4. main path — full-width ViT-16-CIFAR trained by ``ssfl`` for two rounds
     through ``repro_torch.federated.Engine`` with the kernels on
     (``use_pallas=True``), then evaluated with the global head and the
     local ensemble; every kernel's launch count must be > 0. The same run
     with the kernels off must agree (round losses and final parameters
     within 1e-4). A profiled extra round reports device time by kernel;
  5. the ``kernels`` summary line.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without it; so does a machine without a CUDA device, and a
directory that holds this script without the port beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
ROUNDS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, *, warmup: int = 3, reps: int = 25) -> float:
    """Median of ``reps`` CUDA-event-timed calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------- phase 1
def phase_environment():
    import torch
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "environment", "card": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return card


# --------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    res = B.build(B.KERNEL_SOURCES, ptxas_verbose=True)
    wall = time.perf_counter() - t0
    emit({"phase": "build", "wall_s": round(wall, 3),
          "per_source_s": {k: round(v["seconds"], 3) for k, v in res.items()},
          "ptxas": {k: [ln for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in res.items()}})


# --------------------------------------------------------------- phase 3
def _check(name, got, want, rtol, atol):
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    mx = float(err.max()) if err.numel() else 0.0
    if not ok:
        die(f"{name}: kernel disagrees with its plain version "
            f"(max abs err {mx}, rtol {rtol}, atol {atol})")
    return mx


def phase_fuse(client_shape):
    import torch
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    w = torch.full((), 0.37, dtype=torch.float32, device=dev)
    checks = {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        for shape in (client_shape, (4, 7, 13)):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            b = torch.randn(shape, generator=gen, device=dev).to(dtype)
            for cs in (1.0, 0.7):
                got = O.fuse_leaf(a, b, w, cs)
                want = R.fuse(a, b, w, cs)
                key = f"{tuple(shape)}/{str(dtype)[6:]}/cs={cs}"
                checks[key] = _check(f"fuse {key}", got, want, tol, tol)
    # an unaligned leaf (offset by one element) takes the scalar loop
    flat = torch.randn(4 * 7 * 13 + 1, generator=gen, device=dev)
    a, b = flat[1:].view(4, 7, 13), flat[:-1].view(4, 7, 13).flip(0)
    b = b.contiguous()
    checks["unaligned"] = _check("fuse unaligned", O.fuse_leaf(a, b, w),
                                 R.fuse(a, b, w, 1.0), 1e-6, 1e-6)
    torch.cuda.synchronize()

    a = torch.randn(client_shape, generator=gen, device=dev)
    b = torch.randn(client_shape, generator=gen, device=dev)
    n = a.numel()
    ms = time_ms(lambda: O.fuse_leaf(a, b, w))
    plain_ms = time_ms(lambda: R.fuse(a, b, w, 1.0))
    library_ms = time_ms(lambda: torch.lerp(b, a, w))   # b + w·(a − b)
    bound_ms, bound_by = bound(12.0 * n, 4.0 * n)
    row = {"name": "fuse", "route": "cuda",
           "source": "src/repro_torch/csrc/tpgf_fusion.cu",
           "replaces": "src/repro/kernels/tpgf_fusion/kernel.py:33",
           "shape": list(client_shape), "dtype": "float32",
           "max_abs_err": checks[f"{tuple(client_shape)}/float32/cs=1.0"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.lerp(b, a, w)"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


def phase_aggregate(n_clients, n_layers, feat):
    import torch
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    lam = 0.01
    checks = {}

    def weights(N, Lk):
        ww = torch.rand((N, Lk), generator=gen, device=dev)
        ww[min(2, N - 1)] = 0.0                    # a client that never trained
        ww[N // 2, Lk // 2:] = 0.0                 # a shallow client
        return ww

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for N, Lk, F in ((n_clients, n_layers, feat), (5, 3, 1003)):
            c = torch.randn((N, Lk, F), generator=gen, device=dev).to(dtype)
            s = torch.randn((Lk, F), generator=gen, device=dev).to(dtype)
            ww = weights(N, Lk)
            key = f"{(N, Lk, F)}/{str(dtype)[6:]}"
            checks[key] = _check(f"aggregate {key}", O.aggregate_leaf(
                c, ww, s, lam), R.aggregate(c, ww, s, lam), tol,
                tol * 0.1)
            del c, s
    # all-zero weights: (0 + lam·s) / (0 + lam) is s to within one ulp
    c = torch.randn((3, 4, 777), generator=gen, device=dev)
    s = torch.randn((4, 777), generator=gen, device=dev)
    got = O.aggregate_leaf(c, torch.zeros((3, 4), device=dev), s, lam)
    ulp = torch.nextafter(s.abs(), torch.full_like(s, math.inf)) - s.abs()
    if not bool(torch.all((got - s).abs() <= ulp)):
        die("aggregate: all-zero weights must return s to within one ulp")
    checks["all_zero_ww"] = float((got - s).abs().max())
    torch.cuda.synchronize()

    N, Lk, F = n_clients, n_layers, feat
    c = torch.randn((N, Lk, F), generator=gen, device=dev)
    s = torch.randn((Lk, F), generator=gen, device=dev)
    ww = weights(N, Lk)
    ms = time_ms(lambda: O.aggregate_leaf(c, ww, s, lam))
    plain_ms = time_ms(lambda: R.aggregate(c, ww, s, lam))
    library_ms = time_ms(lambda: torch.einsum("nl,nlf->lf", ww, c))
    bound_ms, bound_by = bound(4.0 * N * Lk * F + 8.0 * Lk * F + 4.0 * N * Lk,
                               2.0 * N * Lk * F + 3.0 * Lk * F)
    row = {"name": "aggregate", "route": "cuda",
           "source": "src/repro_torch/csrc/layer_aggregate.cu",
           "replaces": "src/repro/kernels/layer_aggregate/kernel.py:34",
           "shape": [N, Lk, F], "dtype": "float32",
           "max_abs_err": checks[f"{(N, Lk, F)}/float32"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.einsum('nl,nlf->lf', ww, c) "
                           "(the numerator only)"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


# --------------------------------------------------------------- phase 4
def _engine(cfg):
    from repro_torch.federated import Engine
    return Engine(cfg, 8, "ssfl", seed=0, lr=0.05, local_steps=2,
                  batch_size=32, availability=0.9, device="cuda")


def _run(cfg, label):
    import torch
    eng = _engine(cfg)
    recs = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = eng.run_round()
        torch.cuda.synchronize()
        rec = {**rec, "wall_s": time.perf_counter() - t0}
        if not math.isfinite(rec["loss"]):
            die(f"{label}: round {rec['round']} loss is not finite")
        emit({"phase": "round", "run": label, **rec})
        recs.append(rec)
    return eng, recs


def phase_main_path():
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.supernet import split_params
    from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
    from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf
    from repro_torch.tree import tree_flatten_with_path, tree_get

    cfg = get_config("vit16_cifar")
    torch.cuda.reset_peak_memory_stats()
    fuse_leaf.launches = 0
    aggregate_leaf.launches = 0
    eng, recs = _run(cfg.replace(use_pallas=True), "kernels")
    launches = {"fuse": fuse_leaf.launches,
                "aggregate": aggregate_leaf.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_clients = eng.state.n_clients
    param_mb = sum(x.numel() * x.element_size() for _, x in
                   tree_flatten_with_path(eng.state.params)) / 2**20
    client_full = split_params(cfg, eng.state.params, None)[0]
    workspace_mb = n_clients * sum(
        x.numel() * x.element_size() for _, x in
        tree_flatten_with_path(client_full)) / 2**20
    acc_global = eng.evaluate(head="global")
    acc_local = eng.evaluate(head="local")
    for name, acc in (("global", acc_global), ("local", acc_local)):
        if not 0.0 <= acc <= 1.0:
            die(f"evaluate(head={name}) gave {acc}")
    emit({"phase": "main_path", "config": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "clients": 8, "depths": eng.state.fleet.depths.tolist(),
          "rounds": ROUNDS, "launches": launches,
          "accuracy_global": acc_global, "accuracy_local": acc_local,
          "params_mb": param_mb, "workspace_mb": workspace_mb,
          "peak_mem_gb": peak_gb})
    if min(launches.values()) <= 0:
        die(f"a kernel of the main path was never launched: {launches}")

    # the same run through the plain versions must agree
    fuse_leaf.launches = 0
    aggregate_leaf.launches = 0
    plain, precs = _run(cfg, "plain")
    if fuse_leaf.launches or aggregate_leaf.launches:
        die("use_pallas=False still launched a kernel")
    dloss = max(abs(a["loss"] - b["loss"]) for a, b in zip(recs, precs))
    dparam = 0.0
    for path, x in tree_flatten_with_path(eng.state.params):
        y = tree_get(plain.state.params, path)
        dparam = max(dparam, float((x - y).abs().max()))
    acc_plain = plain.evaluate(head="global")
    emit({"phase": "agreement", "max_loss_diff": dloss,
          "max_param_diff": dparam, "accuracy_global_plain": acc_plain})
    if dloss > 1e-4 or dparam > 1e-4:
        die(f"kernel and plain runs disagree: loss {dloss}, params {dparam}")
    del plain
    torch.cuda.empty_cache()
    _profile_round(eng, recs[-1]["wall_s"])
    return launches


def _profile_round(eng, unprofiled_wall_s: float):
    """One more round under torch.profiler: device time by kernel, and the
    device's idle share against the last unprofiled round's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_round()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    averages = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total") if len(averages) else None
    # device-side rows (kernels, copies) carry no CPU time; the operator
    # rows above them repeat their children's device time
    rows = []
    for ev in averages:
        dev_us = getattr(ev, attr, 0)
        if dev_us > 0 and ev.cpu_time_total == 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    if attr is not None:
        (out / "chip_smoke_profile.txt").write_text(
            averages.table(sort_by=attr, row_limit=60))
    unprofiled_ms = unprofiled_wall_s * 1e3
    emit({"phase": "profile", "profiled_wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms,
          "unprofiled_round_wall_ms": unprofiled_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / unprofiled_ms),
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                  for us, k, n in rows[:15]]})


# ------------------------------------------------------------------- main
def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        die(f"{SRC / 'repro_torch'} not found: run this script from the "
            "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    try:
        import torch  # noqa: F401
    except ImportError:
        die("torch is not installed")
    phase_environment()
    import torch
    phase_build()
    from repro_torch.configs.base import get_config
    from repro_torch.federated.simulator import make_fleet
    cfg = get_config("vit16_cifar")
    d_max = int(make_fleet(cfg, 8, seed=0).depths.max())
    rows = [phase_fuse((d_max, cfg.d_model, cfg.d_ff)),
            phase_aggregate(8, cfg.n_layers, cfg.d_model * cfg.d_ff)]
    torch.cuda.empty_cache()
    launches = phase_main_path()
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
