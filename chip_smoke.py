#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, one JSON line each (plus the card's name and power limit as
``nvidia-smi`` prints them):

  1. environment — card, power limit, torch and CUDA versions; TF32 off;
  2. build — every CUDA kernel of the port, one ``nvcc`` per source, all
     started together, from ``src/repro_torch/csrc``;
  3. kernels — each kernel's wrapper (``fuse``, ``aggregate``,
     ``tier_sum``, ``sumsq``, ``flash_attention``, ``ssd_scan``) against
     its plain PyTorch version on the card at the paths' shapes (and
     ragged, unaligned, zero-weight, windowed, MQA, every head dim, bf16,
     every (head_dim, state) pair, no-D and overflow cases), with times
     from CUDA events: kernel, plain version, one PyTorch library call
     where one computes the same function (none does for ``ssd_scan``),
     and the bound (bytes over 3.35 TB/s vs operations over the peak of
     their type: 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s
     bf16); ``flash_attention`` and ``ssd_scan`` are timed at both of
     their paths' shapes and carry their ``ptxas`` registers and spills,
     and ``fuse`` also in bf16 at the LM training path's largest client
     leaf (within one bf16 ulp; a ``kernel_bf16`` line);
     then, where the machine has ``ncu``, one ``ncu --set full`` profile
     of each at its path's shape (``--ncu-target`` is that profile's
     target, not a mode to run by hand);
  4. main path — full-width ViT-16-CIFAR trained by ``ssfl`` for two rounds
     through ``repro_torch.federated.Engine`` with the kernels on
     (``use_pallas=True``), then evaluated with the global head and the
     local ensemble; ``fuse`` and ``aggregate`` must launch. The same run
     with the kernels off must agree (round losses and final parameters
     within 1e-4). A profiled extra round reports device time by kernel;
  5. width path — the same fleet on the width ladder (0.25, 0.5, 0.75,
     1.0) with ``cross_tier="fused"``: two mixed-width cohorts, so
     ``fuse``, ``aggregate`` and ``tier_sum`` must launch; kernels off
     must agree within 1e-4; both heads evaluate; a profiled round;
  6. clip path — ``fuse_tree(tau=0.5)`` (the Phase-1 clip fused into
     Eq. 4) over the depth-10 client's gradient shapes: ``sumsq`` and
     ``fuse`` must launch, and the result must match
     ``clip_by_global_l2`` + ``fuse_gradients`` (rtol 1e-4, atol 1e-6);
  7. baseline path — the main path's fleet and settings trained by the
     SplitFed baselines ``sfl`` and ``dfl``: with the kernels on,
     ``aggregate`` must launch and no other kernel (``fuse`` least of
     all); kernels off must launch nothing and agree within 1e-4; both
     heads evaluate, peak memory, a profiled round; their launches get a
     line of their own;
  8. fedavg path — ``fedavg``, ``fedavgm``, ``fedadam`` and ``fedyogi``
     on the same fleet for two rounds each with the kernels on: finite
     losses, no kernel launch (none lies on this path), the global head
     evaluated, the server slot named; one profiled round of ``fedavg``
     and of ``fedadam``;
  9. scenario path — the main path's fleet under the scenario strategies,
     two rounds each with the kernels on, then off (within 1e-4, nothing
     launched): ``unstable`` at its defaults (Markov participation,
     staleness-weighted Eq. 6/8; ``fuse`` and ``aggregate`` must launch;
     each round's participants and staleness printed),
     ``async_buffered`` with a capacity-3 FedBuff buffer, ``"count"``
     flushes and a ``fedadam`` server at lr 1e-3 (``fuse`` and
     ``aggregate``; at least one flush; the buffer's bytes printed) and
     ``hasfl`` on the width ladder with ``cross_tier="fused"`` and a
     budget that leaves a mixed-width cohort (``fuse``, ``aggregate`` and
     ``tier_sum``; every client's tuned depth, batch and width printed
     each round); both heads evaluate, peak memory, a profiled round each
     (its idle share against the same round run unprofiled on a copy of
     the engine); their launches get a line of their own;
 10. resume — ``ssfl`` with ``adamw`` (lr 0.01, kernels on), ``sfl`` with
     ``adamw``, ``fedadam``, ``unstable`` and ``async_buffered`` (the
     scenario path's buffer and ``fedadam`` server; the save lands
     mid-fill): 1 round, ``save``, a fresh engine, ``restore``, 1 more
     round must equal 2 uninterrupted rounds bit for bit (params, local
     heads, ``opt_state``, the participation chain); prints the
     checkpoint's size and its save and restore times (a temporary
     directory, removed afterwards);
 11. serve path — Llama-3.2-3B at full width in bf16 (28 layers, random
     weights drawn on the card from a seed), the ViT engines freed first:
     4 prompts of 2,048 tokens from ``synthetic_lm_batches`` prefilled
     through ``launch.steps.make_prefill_step`` (``use_pallas=True``:
     ``flash_attention`` must launch 28 times), then 32 greedy decode
     steps through ``make_serve_step``. The same weights with the kernels
     off must agree (prefill logits, and 32 decode steps fed the same
     tokens), and decode from a 2,016-token prefill must reproduce the
     full prefill's logits at positions 2016-2047 (both within
     ``SERVE_LOGIT_TOL`` of the largest logit). Prints prefill and decode
     times and rates, peak memory, the weights' init time, one profiled
     prefill and one profiled decode step;
 12. ssm serve path — the same contract for Mamba2-2.7B at full width and
     depth in bf16 (64 layers, d_model 2560, 80 SSM heads of 64, state
     128), the Llama weights freed first: ``ssd_scan`` must launch 64
     times a prefill and ``flash_attention`` never. Its bf16 agreements
     are held to ``BF16_LOGIT_TOL["ssm"]``, and the same three
     agreements in fp32 at full size to ``FP32_LOGIT_TOL``;
 13. hybrid serve path — the same for Hymba-1.5B (32 layers, d_model
     1600, 25 query and 5 KV heads of 64, 50 SSM heads of 64, state 16):
     ``flash_attention`` and ``ssd_scan`` must each launch 32 times a
     prefill; its launches get a line of their own;
 14. lm train path — Mamba2-2.7B at full width and depth trained by
     ``launch.steps.make_train_step`` with its config (bf16, remat, 4
     microbatches, AdamW with fp32 moments), 3 steps of 8 × 512 tokens
     from ``synthetic_lm_batches``, the serving weights freed first, with
     the kernels on: Eq. 4 runs ``fuse`` on the bf16 client gradients,
     once per client leaf and microbatch, and no other kernel may launch
     (the scan records a gradient, so it takes ``ssd_chunked``). The
     gate on the kernel: the first microbatch's fused client gradient,
     kernels on vs off, within one bf16 ulp elementwise, the losses
     equal. Then the same steps with the kernels off from the same
     weights: step-1 losses bit for bit, later ones within
     ``TRAIN_LOSS_RTOL``. Step wall, tokens/s, peak memory, a profiled
     step;
 15. dense train path — Llama-3.2-3B at full width and depth trained
     through ``launch/train.py``'s config and loop (one microbatch,
     bf16, remat, ``adamw(1e-3)``) with the kernels off, 3 steps of
     8 × 512: finite losses, no kernel launch, the same figures;
 16. the ``kernels`` summary line; each kernel's ``launches`` come from
     the path named beside it (counts set to 0 just before that path),
     and ``also_on`` lists their launches on the scenario paths; the two
     training paths' launches get a line of their own.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without it; so does a machine without a CUDA device, and a
directory that holds this script without the port beside it.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
ROUNDS = 2
LADDER = (0.25, 0.5, 0.75, 1.0)     # the width path's supernet tiers
PORT_KERNELS = ("fuse_kernel", "aggregate_kernel", "tier_sum_kernel",
                "sumsq_partial_kernel", "sumsq_final_kernel",
                "flash_attention_f32_kernel", "flash_attention_bf16_kernel",
                "ssd_cb_kernel", "ssd_scan_kernel")
SERVE_ARCH = "llama3_2_3b"
SSM_ARCH = "mamba2_2_7b"
HYBRID_ARCH = "hymba_1_5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# ssd_scan against its plain version: y and h within this much of their
# largest magnitude, the reference kernel's own bar (test_kernels.py)
SSD_TOL = 1e-4
# the chunk at which _ssd_bound counts the chunked form's own terms: fixed,
# so the yardstick does not move with the kernel's own chunk
SSD_BOUND_CHUNK = 32
# kernels on vs off, and decode vs the teacher-forced prefill, as
# max |Δlogit| / max |logit|: both sides run bf16 through 28 layers, and
# the flash kernel rounds its output to bf16 from another fp32 order than
# plain attention, so single ulps of the bf16 residual stream differ; the
# JAX package's own decode parity bound is 2e-3 in fp32 at 2 layers
SERVE_LOGIT_TOL = 2e-2
# the ssm and hybrid families in bf16: random weights through 32–64
# layers amplify single-ulp differences (the kernel rounds its fp32 sums
# in another order than the plain scan), so on the H100 the three bf16
# agreements read 0.145–0.155 at Mamba2's 64 layers and 0.031–0.035 at
# Hymba's 32, the same in every run; the limits stand 30 % and 43 %
# above the largest of them. The gate on the kernels themselves is the
# same three agreements in fp32 at full width and depth (readings
# 3.0e-6–4.1e-5), held to FP32_LOGIT_TOL
BF16_LOGIT_TOL = {"dense": SERVE_LOGIT_TOL, "ssm": 0.2, "hybrid": 5e-2}
FP32_LOGIT_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    end(1)


def end(code: int) -> None:
    """Exit now with ``code``, leaving nothing running. Every child this
    script starts (``nvidia-smi``, one ``nvcc`` per source) has been waited
    for before this is reached; the process ends without Python's
    finalization, so no library's exit-time teardown (the profiler's CUPTI
    state, the CUDA context, cuBLAS handles) runs after the result is out:
    the card is released when the process is gone."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def bound(nbytes: float, flops: float, peak_flops_per_s: float):
    """The least time (ms) the card could take: bytes over the memory
    rate vs operations over ``peak_flops_per_s``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, *, warmup: int = 3, reps: int = 20,
            samples: int = 5) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls (so the host's enqueue time hides behind the device's work),
    divided by ``reps``; the median of ``samples`` such runs, after
    ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


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
def ptxas_figures(log: str, kernel: str):
    """``{"<kernel><args>": {"registers", "spill_stores", "spill_loads"}}``
    for every instance of ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            cur = None
            if f"{kernel}I" in name or name.endswith(kernel):
                args = re.findall(r"Li(\d+)E", name.split(kernel, 1)[1])
                cur = f"{kernel}<{', '.join(args)}>" if args else kernel
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Builds every source; returns ``{source: nvcc's log}``."""
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    res = B.build(B.KERNEL_SOURCES, ptxas_verbose=True)
    wall = time.perf_counter() - t0
    emit({"phase": "build", "wall_s": round(wall, 3),
          "per_source_s": {k: round(v["seconds"], 3) for k, v in res.items()},
          "ptxas": {k: [ln for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in res.items()}})
    return {k: v["log"] for k, v in res.items()}


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


def phase_fuse(client_shape, bf16_shape):
    """``fuse`` against its plain version (fp32 and bf16, the main path's
    largest client leaf and small ragged ones), timed at the main path's
    fp32 leaf (the returned row) and at ``bf16_shape``, the LM training
    path's largest bf16 client leaf (a line of its own)."""
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
            for cs in (1.0, 0.7, torch.full((), 0.3, device=dev)):
                got = O.fuse_leaf(a, b, w, cs)
                want = R.fuse(a, b, w, cs)
                key = f"{tuple(shape)}/{str(dtype)[6:]}/cs={float(cs)}"
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
    one = torch.ones((), dtype=torch.float32, device=dev)
    n = a.numel()
    # as fuse_tree calls it: weight and clip scale already on the device
    ms = time_ms(lambda: O.fuse_leaf(a, b, w, one))
    plain_ms = time_ms(lambda: R.fuse(a, b, w, one))
    library_ms = time_ms(lambda: torch.lerp(b, a, w))   # b + w·(a − b)
    bound_ms, bound_by = bound(12.0 * n, 4.0 * n, FP32_FLOPS_PER_S)
    row = {"name": "fuse", "route": "cuda",
           "source": "src/repro_torch/csrc/tpgf_fusion.cu",
           "replaces": "src/repro/kernels/tpgf_fusion/kernel.py:33",
           "shape": list(client_shape), "dtype": "float32",
           "max_abs_err": checks[f"{tuple(client_shape)}/float32/cs=1.0"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.lerp(b, a, w)"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    del a, b

    # bf16, as the LM training path calls it: w from Eq. 3 and the clip
    # scale 1.0 on the device; one bf16 ulp is the limit
    a = torch.randn(bf16_shape, generator=gen, device=dev).bfloat16()
    b = torch.randn(bf16_shape, generator=gen, device=dev).bfloat16()
    got, want = O.fuse_leaf(a, b, w, one), R.fuse(a, b, w, one)
    ulps = int((_bf16_order(got) - _bf16_order(want)).abs().max())
    if ulps > 1:
        die(f"fuse bf16 {tuple(bf16_shape)}: {ulps} bf16 ulps from its "
            "plain version")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    n = a.numel()
    bf16 = {"name": "fuse", "shape": list(bf16_shape), "dtype": "bfloat16",
            "max_abs_err": err, "max_bf16_ulps": ulps,
            "ms": time_ms(lambda: O.fuse_leaf(a, b, w, one)),
            "plain_ms": time_ms(lambda: R.fuse(a, b, w, one)),
            "library_ms": time_ms(lambda: torch.lerp(b, a, w.bfloat16())),
            "library_call": "torch.lerp(b, a, w) in bf16"}
    bf16["bound_ms"], bf16["bound_by"] = bound(6.0 * n, 4.0 * n,
                                               FP32_FLOPS_PER_S)
    emit({"phase": "kernel_bf16", **bf16})
    del a, b
    torch.cuda.empty_cache()
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
                               2.0 * N * Lk * F + 3.0 * Lk * F,
                               FP32_FLOPS_PER_S)
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


def phase_tier_sum(shape):
    import torch
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    checks = {}

    def case(key, T, shp, zero_last=False, offset=False):
        xs = [torch.randn(shp, generator=gen, device=dev) for _ in range(T)]
        if offset:      # an unaligned leaf takes the scalar loop
            flat = torch.randn(xs[0].numel() + 1, generator=gen, device=dev)
            xs[0] = flat[1:].view(shp)
        w = torch.rand(T, generator=gen, device=dev) * 2
        if zero_last:
            w[-1] = 0.0
        checks[key] = _check(f"tier_sum {key}", O.tier_sum_leaf(xs, w),
                             R.tier_sum(xs, list(w)), 0.0, 0.0)

    case(f"{tuple(shape)}/T=2", 2, shape)
    case(f"{tuple(shape)}/T=2/zero-weight", 2, shape, zero_last=True)
    case("(4, 7, 13)/T=3/ragged", 3, (4, 7, 13))
    case("(4, 7, 13)/T=3/unaligned", 3, (4, 7, 13), offset=True)
    case("(1000,)/T=1", 1, (1000,))
    case("(33, 65)/T=4/zero-weight", 4, (33, 65), zero_last=True)
    torch.cuda.synchronize()

    T = 2
    xs = [torch.randn(shape, generator=gen, device=dev) for _ in range(T)]
    w = torch.rand(T, generator=gen, device=dev)
    n = xs[0].numel()
    ms = time_ms(lambda: O.tier_sum_leaf(xs, w))
    plain_ms = time_ms(lambda: R.tier_sum(xs, list(w)))
    stacked = torch.stack(xs)             # outside the timed call
    library_ms = time_ms(lambda: torch.tensordot(w, stacked, dims=1))
    del stacked
    bound_ms, bound_by = bound(4.0 * (T + 1) * n, (2.0 * T - 1) * n,
                               FP32_FLOPS_PER_S)
    row = {"name": "tier_sum", "route": "cuda",
           "source": "src/repro_torch/csrc/tpgf_fusion.cu",
           "replaces": "src/repro/kernels/tpgf_fusion/kernel.py:64",
           "shape": [T] + list(shape), "dtype": "float32",
           "max_abs_err": checks[f"{tuple(shape)}/T=2"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.tensordot(w, X, dims=1) on a pre-stacked "
                           "X (the stack is not timed)"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


def phase_sumsq(cfg, d_max):
    import torch
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    checks = {}
    shape = (d_max, cfg.d_model, cfg.d_ff)
    for dtype in (torch.float32, torch.bfloat16):
        for shp in (shape, (4, 7, 13), (1,)):
            x = torch.randn(shp, generator=gen, device=dev).to(dtype)
            a, b = O.sumsq_leaf(x), O.sumsq_leaf(x)
            key = f"{tuple(shp)}/{str(dtype)[6:]}"
            if not torch.equal(a, b):
                die(f"sumsq {key}: two calls on one input differ "
                    f"({float(a)!r} vs {float(b)!r})")
            checks[key] = _check(f"sumsq {key}", a, R.sumsq(x), 1e-5, 0.0)
    torch.cuda.synchronize()

    x = torch.randn(shape, generator=gen, device=dev)
    n = x.numel()
    total = torch.zeros((), dtype=torch.float32, device=dev)
    ms = time_ms(lambda: O.sumsq_leaf(x, total))
    plain_ms = time_ms(lambda: R.sumsq(x))
    flat = x.view(-1)
    library_ms = time_ms(lambda: torch.dot(flat, flat))
    bound_ms, bound_by = bound(4.0 * n, 2.0 * n, FP32_FLOPS_PER_S)
    row = {"name": "sumsq", "route": "cuda",
           "source": "src/repro_torch/csrc/tpgf_fusion.cu",
           "replaces": "src/repro/kernels/tpgf_fusion/kernel.py:100",
           "shape": list(shape), "dtype": "float32",
           "max_abs_err": checks[f"{tuple(shape)}/float32"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.dot(x.view(-1), x.view(-1))"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


def _attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the masks leave, summed over the rows."""
    total = 0
    for r in range(Sq):
        hi = min(r, Skv - 1) if causal else Skv - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def phase_flash(shape, hybrid_shape, build_log):
    """``flash_attention`` against its plain version on the card: the
    serve path's shape and Hymba's in bf16 and fp32, a window, MQA, every
    head dim, ragged S (one row past a tile), a window across tile edges,
    Sq = 1, Sq and Skv unequal, and non-causal cases; timed in bf16 at the
    serve path's shape and at Hymba's, each beside SDPA and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"
    B, S, H, K, hd = shape
    tols = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
    hb, hs, hh, hk, hhd = hybrid_shape
    # (key, (B, Sq, Skv, H, K, hd), causal, window)
    cases = [(f"path/{B}x{S}x{H}x{K}x{hd}", (B, S, S, H, K, hd), True, 0),
             (f"hymba/{hb}x{hs}x{hh}x{hk}x{hhd}", (hb, hs, hs, hh, hk, hhd),
              True, 0),
             ("window256", (1, S, S, H, K, hd), True, 256),
             ("mqa", (2, 512, 512, 8, 1, hd), True, 0),
             ("hd32", (1, 256, 256, 4, 2, 32), True, 0),
             ("hd64", (1, 256, 256, 4, 2, 64), True, 0),
             ("hd128", (1, 256, 256, 4, 2, 128), True, 0),
             ("hd256", (1, 256, 256, 4, 2, 256), True, 0),
             ("ragged1000", (2, 1000, 1000, H, K, hd), True, 0),
             ("ragged129", (2, 129, 129, 4, 2, 128), True, 0),
             ("window100_causal", (1, 300, 300, 4, 4, 64), True, 100),
             ("sq1", (2, 1, 1, 4, 2, 64), True, 0),
             ("sq1000_skv129", (2, 1000, 129, 4, 2, 128), True, 0),
             ("sq129_skv1000", (2, 129, 1000, 4, 2, 128), True, 0),
             ("sq1_skv300_noncausal", (2, 1, 300, 4, 2, 256), False, 0),
             ("noncausal", (1, 300, 300, 4, 4, 64), False, 0),
             ("noncausal_window100", (1, 300, 300, 4, 4, 64), False, 100)]

    def inputs(b, sq, skv, h, k, d, dtype):
        return (torch.randn((b, sq, h, d), generator=gen,
                            device=dev).to(dtype),
                torch.randn((b, skv, k, d), generator=gen,
                            device=dev).to(dtype),
                torch.randn((b, skv, k, d), generator=gen,
                            device=dev).to(dtype))

    checks = {}
    with torch.no_grad():
        for name, (b, sq, skv, h, k, d), causal, window in cases:
            for dtype, tol in tols.items():
                q, kk, v = inputs(b, sq, skv, h, k, d, dtype)
                key = f"{name}/{str(dtype)[6:]}"
                checks[key] = _check(
                    f"flash_attention {key}",
                    O.flash_attention(q, kk, v, causal=causal,
                                      window=window),
                    R.flash_attention_ref(q, kk, v, causal=causal,
                                          window=window), tol, tol)
                del q, kk, v
        torch.cuda.synchronize()

        def timed(b, s, h, k, d):
            q, kk, v = inputs(b, s, s, h, k, d, torch.bfloat16)
            ms = time_ms(lambda: O.flash_attention(q, kk, v, causal=True))
            plain_ms = time_ms(lambda: R.flash_attention_ref(q, kk, v,
                                                             causal=True))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True))
            flops = 4.0 * d * b * h * _attended_pairs(s, s, True, 0)
            nbytes = 2.0 * (2 * q.numel() + kk.numel() + v.numel())
            return ms, plain_ms, library_ms, flops, nbytes

        ms, plain_ms, library_ms, flops, nbytes = timed(B, S, H, K, hd)
        h_ms, h_plain_ms, h_library_ms, h_flops, h_nbytes = timed(
            *hybrid_shape)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
           "shape": [B, S, H, K, hd], "dtype": "bfloat16",
           "max_abs_err": checks[f"{cases[0][0]}/bfloat16"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "F.scaled_dot_product_attention(q, k, v "
                           "transposed to [B, H, S, hd] views, "
                           "is_causal=True, enable_gqa=True)",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "hybrid_shape": list(hybrid_shape), "hybrid_ms": h_ms,
           "hybrid_plain_ms": h_plain_ms,
           "hybrid_library_ms": h_library_ms,
           "hybrid_bound_ms": bound(h_nbytes, h_flops, BF16_FLOPS_PER_S)[0],
           "ptxas": ptxas_figures(build_log, "flash_attention_bf16_kernel")}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


def _ssd_bound(Bt, S, nh, hd, st, cl=SSD_BOUND_CHUNK):
    """(bytes, operations) of the SSD scan: the least work the function
    needs, the two state contractions (C·hᵀ and the state update, 2·hd·st
    each per row and head), plus the chunked form's own terms at a chunk
    ``cl`` (fixed at SSD_BOUND_CHUNK, whatever the kernel's own chunk): the
    causal half of W·u, cl²·hd per (batch, head, chunk), and C·Bᵀ,
    2·cl²·st per (batch, chunk). Bytes: x and y once each, B, C, dt, A, D
    and h, fp32."""
    nc = math.ceil(S / cl)
    flops = (4.0 * Bt * S * nh * hd * st + Bt * nh * nc * cl * cl * hd
             + Bt * nc * 2.0 * cl * cl * st)
    nbytes = 4.0 * (2 * Bt * S * nh * hd + 2 * Bt * S * st + Bt * S * nh
                    + 2 * nh + Bt * nh * hd * st)
    return nbytes, flops


def phase_ssd_scan(ssm_shape, hybrid_shape, build_log):
    """``ssd_scan`` against its plain version (``ssd_ref`` at a chunk that
    divides S) on the card: the Mamba2 and Hymba serve shapes,
    ``test_kernels.py``'s shapes, every (head_dim, state) pair, ragged S
    (S not a multiple of the kernel's chunk), S = 1, an odd number of
    heads, D = None, and dt near 1 with A = −16, where an unmasked upper
    half would overflow; y and h finite and within ``SSD_TOL`` of their
    largest magnitude. Timed at the Mamba2 and Hymba serve shapes beside
    the plain version at the chunk ``ssm_apply`` takes (256)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as O, ref as R
    gen = torch.Generator(device="cuda").manual_seed(8)
    dev = "cuda"

    def inputs(Bt, S, nh, hd, st, dt_range=(0.01, 0.2), A=None):
        x = torch.randn((Bt, S, nh, hd), generator=gen, device=dev)
        lo, hi = dt_range
        dt = lo + (hi - lo) * torch.rand((Bt, S, nh), generator=gen,
                                         device=dev)
        if A is None:    # the model's A = −exp(log(linspace(1, 16)))
            A = -torch.linspace(1.0, 16.0, nh, device=dev)
        B = torch.randn((Bt, S, st), generator=gen, device=dev)
        C = torch.randn((Bt, S, st), generator=gen, device=dev)
        D = torch.randn((nh,), generator=gen, device=dev)
        return x, dt, A, B, C, D

    def check(key, got, want):
        for name, g, w in zip(("y", "h"), got, want):
            err = float((g - w).abs().max())
            top = float(w.abs().max())
            if not bool(torch.isfinite(g).all()) or err > SSD_TOL * top:
                die(f"ssd_scan {key}: {name} disagrees with the plain "
                    f"version (max abs err {err}, largest |{name}| {top}, "
                    f"limit {SSD_TOL} of it; finite "
                    f"{bool(torch.isfinite(g).all())})")
        return float((got[0] - want[0]).abs().max())

    # (key, (Bt, S, nh, hd, st), the plain version's chunk, options)
    cases = [("mamba2", ssm_shape, 256, {}),
             ("hymba", hybrid_shape, 256, {}),
             ("tk_2x256x4x32x16", (2, 256, 4, 32, 16), 128, {}),
             ("tk_1x128x2x64x32", (1, 128, 2, 64, 32), 64, {}),
             ("tk_2x64x3x32x16", (2, 64, 3, 32, 16), 64, {}),
             ("tk_1x512x2x32x128", (1, 512, 2, 32, 128), 128, {}),
             ("recurrence_hd8_st4", (1, 32, 2, 8, 4), 16, {}),
             ("hymba_reduced_hd32_st8", (2, 96, 4, 32, 8), 96, {}),
             ("ragged2000", ssm_shape[:1] + (2000,) + ssm_shape[2:], 250,
              {}),
             ("ragged77", (2, 77, 4, 32, 16), 77, {}),
             ("one_row", (3, 1, 2, 64, 128), 1, {}),
             ("ragged999", (2, 999, 6, 64, 128), 333, {}),
             ("one_row_hymba_heads", (1, 1, 50, 64, 16), 1, {}),
             ("odd_heads7", (2, 256, 7, 32, 16), 128, {}),
             ("no_D", (2, 256, 8, 64, 128), 128, {"no_d": True}),
             ("overflow_dt1_A-16", (2, 256, 8, 64, 128), 256,
              {"dt_range": (0.5, 1.0), "A": -16.0})]
    checks = {}
    with torch.no_grad():
        for key, (Bt, S, nh, hd, st), chunk, opt in cases:
            A = (torch.full((nh,), opt["A"], device=dev) if "A" in opt
                 else None)
            x, dt, A, B, C, D = inputs(Bt, S, nh, hd, st,
                                       opt.get("dt_range", (0.01, 0.2)), A)
            if opt.get("no_d"):
                D = None
            checks[key] = check(key, O.ssd_scan(x, dt, A, B, C, D),
                                R.ssd_ref(x, dt, A, B, C, D, chunk=chunk))
            del x, dt, B, C
        torch.cuda.synchronize()

        times = {}
        for label, shape in (("mamba2", ssm_shape), ("hymba", hybrid_shape)):
            x, dt, A, B, C, D = inputs(*shape)
            times[label] = (
                time_ms(lambda: O.ssd_scan(x, dt, A, B, C, D)),
                time_ms(lambda: R.ssd_ref(x, dt, A, B, C, D, chunk=256)))
            del x, dt, B, C
    ms, plain_ms = times["mamba2"]
    nbytes, flops = _ssd_bound(*ssm_shape)
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOPS_PER_S)
    hb_bytes, hb_flops = _ssd_bound(*hybrid_shape)
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
           "shape": list(ssm_shape), "dtype": "float32",
           "max_abs_err": checks["mamba2"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "library_call": "none: no single PyTorch call computes the SSD "
                           "scan",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "hybrid_shape": list(hybrid_shape),
           "hybrid_ms": times["hymba"][0],
           "hybrid_plain_ms": times["hymba"][1],
           "hybrid_bound_ms": bound(hb_bytes, hb_flops,
                                    FP32_FLOPS_PER_S)[0],
           "kernel_chunk": O.KERNEL_CHUNK,
           "ptxas": {**ptxas_figures(build_log, "ssd_cb_kernel"),
                     **ptxas_figures(build_log, "ssd_scan_kernel")}}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


# --------------------------------------------------------------- phase 4
# the training paths' fleet: 8 clients, seed 0, SGD lr 0.05, 2 local
# steps, batch 32, availability 0.9 (``strategy`` and any of these may be
# overridden)
TRAIN_ARGS = dict(strategy="ssfl", seed=0, lr=0.05, local_steps=2,
                  batch_size=32, availability=0.9)


def _engine(cfg, **kw):
    """An engine on the training paths' fleet; ``strategy`` is a name or a
    factory (called once per engine: strategies keep per-run state)."""
    from repro_torch.federated import Engine
    args = dict(TRAIN_ARGS, **kw)
    strategy = args.pop("strategy")
    if callable(strategy):
        strategy = strategy()
    return Engine(cfg, 8, strategy, device="cuda", **args)


def _run(cfg, label, describe=None, **kw):
    """``ROUNDS`` rounds, each a ``round`` line (``describe(engine)`` adds
    its entries to it)."""
    import torch
    eng = _engine(cfg, **kw)
    recs = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = eng.run_round()
        torch.cuda.synchronize()
        rec = {**rec, "wall_s": time.perf_counter() - t0}
        if not math.isfinite(rec["loss"]):
            die(f"{label}: round {rec['round']} loss is not finite")
        emit({"phase": "round", "run": label, **rec,
              **(describe(eng) if describe else {})})
        recs.append(rec)
    return eng, recs


def _wrappers():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.tpgf_fusion.ops import (fuse_leaf, sumsq_leaf,
                                                     tier_sum_leaf)
    return {"fuse": fuse_leaf, "aggregate": aggregate_leaf,
            "tier_sum": tier_sum_leaf, "sumsq": sumsq_leaf,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_path(name, must_launch, forbidden=(), describe=None,
               same_round=False, **engine_kw):
    """Train the fleet two rounds with the kernels on, every launch count
    set to 0 just before and read just after (each kernel of
    ``must_launch`` must have launched, none of ``forbidden``); then the
    same run with the kernels off, which must launch nothing and agree
    within 1e-4; then a profiled round. ``describe(engine)`` adds entries
    to each round's line. ``same_round``: the profiled round's idle share
    is taken against the wall of the SAME round run unprofiled on a copy
    of the engine (a participation process gives every round other
    clients, so the last round's wall does not measure it). Returns
    (launches, the kernel-on engine)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.supernet import split_params
    from repro_torch.tree import tree_flatten_with_path, tree_get

    cfg = get_config("vit16_cifar")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    eng, recs = _run(cfg.replace(use_pallas=True), f"{name}/kernels",
                     describe, **engine_kw)
    launches = _counts()
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
    for head, acc in (("global", acc_global), ("local", acc_local)):
        if not 0.0 <= acc <= 1.0:
            die(f"{name}: evaluate(head={head}) gave {acc}")
    emit({"phase": name, "config": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "clients": n_clients, "depths": eng.state.fleet.depths.tolist(),
          "widths": eng.state.fleet.widths.tolist(),
          "cross_tier": eng.cross_tier, "rounds": ROUNDS,
          "launches": launches,
          "accuracy_global": acc_global, "accuracy_local": acc_local,
          "params_mb": param_mb, "workspace_mb": workspace_mb,
          "peak_mem_gb": peak_gb})
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing:
        die(f"{name}: kernels of the path never launched: {missing} "
            f"({launches})")
    stray = [k for k in forbidden if launches[k] > 0]
    if stray:
        die(f"{name}: kernels off the path launched: {stray} ({launches})")

    # the same run through the plain versions must agree
    _zero_counts()
    plain, precs = _run(cfg, f"{name}/plain", describe, **engine_kw)
    if any(_counts().values()):
        die(f"{name}: use_pallas=False still launched a kernel: "
            f"{_counts()}")
    dloss = max(abs(a["loss"] - b["loss"]) for a, b in zip(recs, precs))
    dparam = 0.0
    for path, x in tree_flatten_with_path(eng.state.params):
        y = tree_get(plain.state.params, path)
        dparam = max(dparam, float((x - y).abs().max()))
    acc_plain = plain.evaluate(head="global")
    emit({"phase": "agreement", "path": name, "max_loss_diff": dloss,
          "max_param_diff": dparam, "accuracy_global_plain": acc_plain})
    if dloss > 1e-4 or dparam > 1e-4:
        die(f"{name}: kernel and plain runs disagree: loss {dloss}, "
            f"params {dparam}")
    del plain
    torch.cuda.empty_cache()
    wall_s = recs[-1]["wall_s"]
    if same_round:
        twin = copy.deepcopy(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin.run_round()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        del twin
        torch.cuda.empty_cache()
    _profile(eng.run_round, wall_s, name)
    return launches, eng


def phase_clip_path(cfg, params, d):
    """``fuse_tree(tau=0.5)`` on the depth-``d`` client's gradient shapes
    (random trees, the clipped one scaled to a norm near 1 so the clip
    scale is near 0.5): ``sumsq`` and ``fuse`` must launch, and the result
    must match ``clip_by_global_l2`` + ``fuse_gradients``."""
    import torch
    from repro_torch.core import tpgf as T
    from repro_torch.core.supernet import split_params
    from repro_torch.kernels.tpgf_fusion import ops as O
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

    client = split_params(cfg, params, d)[0]
    n = sum(x.numel() for x in tree_leaves(client))
    gen = torch.Generator(device="cuda").manual_seed(4)
    gc = tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                        device="cuda") / math.sqrt(n),
                  client)
    gs = tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                        device="cuda"), client)
    w = torch.full((), 0.37, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    _zero_counts()
    got = O.fuse_tree(gc, gs, w, tau=0.5)
    torch.cuda.synchronize()
    launches = _counts()
    missing = [k for k in ("sumsq", "fuse") if launches[k] <= 0]
    if missing:
        die(f"clip_path: kernels of the path never launched: {missing}")
    clipped, norm = T.clip_by_global_l2(gc, 0.5)
    want = T.fuse_gradients(clipped, gs, w)
    flat_want = dict(tree_flatten_with_path(want))
    err = max(_check(f"fuse_tree(tau=0.5) {p}", x, flat_want[p], 1e-4,
                     1e-6) for p, x in tree_flatten_with_path(got))

    leaves = tree_leaves(gc)

    def tree_sumsq():
        total = torch.zeros((), dtype=torch.float32, device="cuda")
        for leaf in leaves:
            O.sumsq_leaf(leaf, total)
        return total

    sumsq_tree_ms = time_ms(tree_sumsq)
    sumsq_tree_bound_ms, _ = bound(4.0 * n, 2.0 * n,
                                   FP32_FLOPS_PER_S)
    fuse_tree_ms = time_ms(lambda: O.fuse_tree(gc, gs, w, tau=0.5))
    plain_ms = time_ms(lambda: T.fuse_gradients(
        T.clip_by_global_l2(gc, 0.5)[0], gs, w))
    emit({"phase": "clip_path", "depth": d, "leaves": len(leaves),
          "elements": n, "launches": launches, "norm": float(norm),
          "max_abs_err": err, "fuse_tree_ms": fuse_tree_ms,
          "clip_then_fuse_plain_ms": plain_ms,
          "sumsq_tree_ms": sumsq_tree_ms,
          "sumsq_tree_bound_ms": sumsq_tree_bound_ms})
    return launches


# ------------------------------------------------------ baselines, resume
FEDAVG_FAMILY = ("fedavg", "fedavgm", "fedadam", "fedyogi")
# the scenario path's FedBuff buffer: seed 0's Markov chain over the
# 8-client fleet trains 4 depth cohorts in round 1 and 2 in round 2, so a
# capacity of 3 flushes once in each round, and a checkpoint taken after
# round 1 holds one entry (host numpy draws: found on the CPU)
ASYNC_CAPACITY = 3
# FedAdam's first steps move every coordinate by about its lr; 1e-3 stays
# under the ViT weights' init scale (0.02), where 0.03 (the JAX package's
# reduced-config sweep) sends the full-width loss from 2.07 to 4.61
ASYNC_SERVER_LR = 1e-3
# hasfl's co-tuning budget: at full width this leaves a depth-1 cohort
# of width tiers 0.75 and 1.0 and batches 4-16 (co_tune is host numpy over
# parameter counts: found on the CPU, checked again below by tier_sum)
HASFL_BUDGET = 0.1


def _async_fedadam():
    from repro_torch.federated.strategies import BufferedAsync
    return BufferedAsync(capacity=ASYNC_CAPACITY, server_opt="fedadam",
                         server_lr=ASYNC_SERVER_LR)


def _hasfl_ladder():
    from repro_torch.federated.strategies import HASFL
    return HASFL(width_tiers=LADDER, time_budget_factor=HASFL_BUDGET)


# (label, engine settings): the main path's fleet, kernels on
RESUME_CASES = (("ssfl-adamw", dict(optimizer="adamw", lr=0.01)),
                ("sfl-adamw", dict(strategy="sfl", optimizer="adamw",
                                   lr=0.01)),
                ("fedadam", dict(strategy="fedadam")),
                ("unstable", dict(strategy="unstable")),
                ("async_buffered-fedadam", dict(strategy=_async_fedadam)))


def phase_fedavg_path():
    """The FedAvg family at full width: two rounds each with the kernels
    on (no port kernel lies on this path, so none may launch), finite
    losses, the global head evaluated; one profiled round of ``fedavg``
    and of ``fedadam``."""
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    for name in FEDAVG_FAMILY:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        eng, recs = _run(cfg, f"fedavg_path_{name}", strategy=name)
        launches = _counts()
        if any(launches.values()):
            die(f"fedavg_path {name}: a port kernel launched: {launches}")
        slot = eng.state.opt_state.get("server")
        emit({"phase": f"fedavg_path_{name}", "config": cfg.name,
              "clients": eng.state.n_clients, "rounds": ROUNDS,
              "launches": launches,
              "server_slot": sorted(slot) if slot is not None else None,
              "accuracy_global": eng.evaluate(head="global"),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
        if name in ("fedavg", "fedadam"):
            _profile(eng.run_round, recs[-1]["wall_s"],
                     f"fedavg_path_{name}")
        del eng
        torch.cuda.empty_cache()


def _staleness_line(eng):
    # every client of these fleets is feasible, so the clients that
    # trained this round are the participants: staleness 0
    st = eng._staleness
    return {"participants": [int(i) for i in (st == 0).nonzero()[0]],
            "staleness": st.tolist()}


def _buffer_line(eng):
    from repro_torch.federated import buffer as BUF
    buf = eng.state.opt_state.get(BUF.SLOT)
    return {"flushes": eng.strategy.flushes,
            "buffer_fill": BUF.fill_count(buf) if buf else 0}


def _tuned_line(eng):
    fl = eng.state.fleet
    return {"tuned_depth_batch_width": [
        [int(d), int(b), float(w)]
        for d, b, w in zip(fl.depths, eng.strategy._bs, fl.widths)]}


def phase_scenario_path():
    """The scenario strategies on the main path's fleet (``phase_path``
    each): ``unstable``, ``async_buffered`` (FedBuff, ``fedadam`` server)
    and ``hasfl`` on the width ladder, fused. Returns their launches."""
    import torch
    from repro_torch.federated import buffer as BUF
    from repro_torch.tree import tree_leaves
    launches = {}
    off_path = ("sumsq", "flash_attention", "ssd_scan")
    for name, must, describe, kw in (
            ("unstable", ("fuse", "aggregate"), _staleness_line,
             dict(strategy="unstable")),
            ("async_buffered", ("fuse", "aggregate"), _buffer_line,
             dict(strategy=_async_fedadam)),
            ("hasfl", ("fuse", "aggregate", "tier_sum"), _tuned_line,
             dict(strategy=_hasfl_ladder, cross_tier="fused"))):
        path = f"scenario_path_{name}"
        forbidden = off_path if "tier_sum" in must \
            else off_path + ("tier_sum",)
        launches[path], eng = phase_path(path, must, forbidden, describe,
                                         same_round=True, **kw)
        if name == "async_buffered":
            buf = eng.state.opt_state[BUF.SLOT]
            line = {"phase": f"{path}_buffer",
                    "capacity": BUF.capacity_of(buf),
                    "flushes": eng.strategy.flushes,
                    "buffer_bytes": sum(x.numel() * x.element_size()
                                        for x in tree_leaves(buf)),
                    "fedopt_bytes": sum(
                        x.numel() * x.element_size() for x in tree_leaves(
                            eng.state.opt_state.get("server_fedopt", ())))}
            emit(line)
            if eng.strategy.flushes == 0:
                die(f"{path}: the buffer never flushed ({line})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _first_difference(a, b):
    """The path of the first leaf where two tensor trees differ in any
    bit (or in shape or dtype), else None."""
    import torch
    from repro_torch.tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return "the trees' keys"
    for (path, x), (_, y) in zip(fa, fb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            return path
    return None


def phase_resume():
    """For each of ``RESUME_CASES``: 1 round, ``save``, a fresh engine,
    ``restore``, 1 more round must equal 2 uninterrupted rounds bit for
    bit (params, local heads, opt_state, the participation process's
    state). The checkpoint goes to a temporary directory that is removed
    afterwards."""
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    for label, kw in RESUME_CASES:
        a = _engine(cfg, **kw)
        for _ in range(ROUNDS):
            a.run_round()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            path = os.path.join(tmp, "ck")
            b = _engine(cfg, **kw)
            b.run_round()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.save(path)
            save_s = time.perf_counter() - t0
            del b
            size = sum(os.path.getsize(path + ext)
                       for ext in (".npz", ".json"))
            c = _engine(cfg, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.restore(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        rec = c.run_round()
        diff = {part: _first_difference(getattr(a.state, part),
                                        getattr(c.state, part))
                for part in ("params", "local_heads", "opt_state")}
        if a.participation is not None and \
                a.participation.get_state() != c.participation.get_state():
            diff["participation"] = "the arrival process's state"
        emit({"phase": "resume", "case": label, "round": rec["round"],
              "loss_resumed": rec["loss"],
              "loss_uninterrupted": a.history[-1]["loss"],
              "checkpoint_bytes": size, "save_s": save_s,
              "restore_s": restore_s,
              "first_difference": {k: v and "/".join(map(str, v))
                                   for k, v in diff.items()}})
        if any(v is not None for v in diff.values()) \
                or rec["loss"] != a.history[-1]["loss"]:
            die(f"resume {label}: the resumed run is not bit-identical to "
                f"the uninterrupted one ({diff})")
        del a, c
        torch.cuda.empty_cache()


def _rel_logit_diff(got, want) -> float:
    """max |got − want| / max |want|, in fp32, a slice of the batch at a
    time (the full logits are [4, 2048, 128256])."""
    num, den = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        num = max(num, float((g - w).abs().max()))
        den = max(den, float(w.abs().max()))
    return num / den


def _config_fields(cfg):
    """The widths a serve line reports for ``cfg``'s family."""
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab}
    if cfg.family in ("dense", "hybrid"):
        out.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
        out.update(ssm_d_inner=cfg.ssm_d_inner, ssm_n_heads=cfg.ssm_n_heads,
                   ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    return out


def _serve_agreements(cfg, params, toks, fed):
    """Kernels on vs off — the prefill logits, and decode steps fed the
    tokens ``fed`` (greedy argmax over random weights flips on rounding
    noise) — and decode from a prefill of SERVE_PROMPT − SERVE_GEN tokens
    (kernels on) against the full prefill's logits at the positions it
    decodes; each as max |Δlogit| / max |logit|. Kernels off must launch
    nothing."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    runs = {}
    for on in (True, False):
        c = cfg.replace(use_pallas=on)
        _zero_counts()
        logits, cache = make_prefill_step(c, decode_budget=SERVE_GEN)(
            params, {"tokens": toks})
        serve = make_serve_step(c)
        steps = []
        for tok in fed:
            lg, cache = serve(params, cache, tok)
            steps.append(lg)
        if not on and any(_counts().values()):
            die(f"{cfg.name}: use_pallas=False launched a kernel: "
                f"{_counts()}")
        runs[on] = (logits, torch.cat(steps, 1))
        del cache, steps
    d_prefill = _rel_logit_diff(runs[True][0], runs[False][0])
    d_decode = _rel_logit_diff(runs[True][1], runs[False][1])
    full = runs[True][0]
    del runs
    # the cache on the card: prefill SERVE_PROMPT − SERVE_GEN tokens, then
    # decode the rest teacher-forced; step t's logits are position t's
    on = cfg.replace(use_pallas=True)
    n0 = SERVE_PROMPT - SERVE_GEN
    _, cache = make_prefill_step(on, decode_budget=SERVE_GEN)(
        params, {"tokens": toks[:, :n0]})
    serve = make_serve_step(on)
    tf = []
    for t in range(n0, SERVE_PROMPT):
        lg, cache = serve(params, cache, toks[:, t:t + 1])
        tf.append(lg)
    d_cache = _rel_logit_diff(torch.cat(tf, 1), full[:, n0:])
    return {"prefill_kernels_vs_plain": d_prefill,
            "decode_kernels_vs_plain": d_decode,
            "decode_vs_teacher_forced_prefill": d_cache,
            "max_abs_logit": float(full.float().abs().max())}


def _check_agreements(name, agree, limit):
    for key in ("prefill_kernels_vs_plain", "decode_kernels_vs_plain",
                "decode_vs_teacher_forced_prefill"):
        if not agree[key] <= limit:
            die(f"{name}: {key}: max |Δlogit| / max |logit| = "
                f"{agree[key]} > {limit}")


def phase_serve_path(name, arch, expect):
    """``arch`` at full width, bf16, served through the port's entry
    points: prefill of 4 × 2,048 tokens and 32 greedy decode steps; one
    prefill and its decode must launch each kernel exactly as ``expect``
    says ({name: launches}, every other kernel never); kernels off must
    agree, and decode must reproduce the teacher-forced prefill (the ssm
    and hybrid families also at full width and depth in fp32: see
    FP32_LOGIT_TOL). Returns the launch counts."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import synthetic_lm_batches
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import init_params, param_count

    cfg = get_config(arch).replace(use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    batch = next(synthetic_lm_batches(cfg.vocab, SERVE_PROMPT, SERVE_BATCH,
                                      1, seed=1))
    toks = torch.as_tensor(batch["tokens"], device="cuda").long()
    prefill = make_prefill_step(cfg, decode_budget=SERVE_GEN)
    serve = make_serve_step(cfg)
    V = cfg.vocab

    def run_serve():
        """prefill, then SERVE_GEN greedy steps; returns the prefill
        logits, the tokens fed to decode, each step's logits and the two
        walls."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks})
        tok = logits[:, -1:, :V].argmax(dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fed, step_logits = [], []
        for _ in range(SERVE_GEN):
            fed.append(tok)
            lg, cache = serve(params, cache, tok)
            step_logits.append(lg)
            tok = lg[:, :, :V].argmax(dim=-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return logits, fed, step_logits, t1 - t0, t2 - t1

    run_serve()                               # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    logits_on, fed, steps_on, prefill_s, decode_s = run_serve()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = {k: expect.get(k, 0) for k in launches}
    if launches != want:
        die(f"{name}: one prefill and its decode launched {launches}, "
            f"expected {want}")
    gen_tokens = torch.cat(fed, dim=1)
    finite = bool(torch.isfinite(logits_on).all()) and all(
        bool(torch.isfinite(x).all()) for x in steps_on)
    if logits_on.shape != (SERVE_BATCH, SERVE_PROMPT, cfg.padded_vocab) \
            or not finite:
        die(f"{name}: prefill logits {tuple(logits_on.shape)}, finite "
            f"{finite}")
    ntok = SERVE_BATCH * SERVE_PROMPT
    emit({"phase": name, "config": cfg.name, "dtype": cfg.dtype,
          **_config_fields(cfg), "params": n_params,
          "init_s": init_s, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "decode_steps": SERVE_GEN, "launches": launches,
          "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": ntok / prefill_s,
          "decode_ms_per_step": decode_s * 1e3 / SERVE_GEN,
          "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s,
          "peak_mem_gb": peak_gb,
          "generated_req0": gen_tokens[0, :8].tolist()})

    del logits_on, steps_on
    agree = _serve_agreements(cfg, params, toks, fed)
    limit = BF16_LOGIT_TOL[cfg.family]
    emit({"phase": "serve_agreement", "path": name, "dtype": cfg.dtype,
          "limit": limit, **agree})
    _check_agreements(name, agree, limit)
    torch.cuda.empty_cache()
    held = {}

    def profiled_prefill():
        held["out"] = prefill(params, {"tokens": toks})

    prefix = name.removesuffix("_path")
    _profile(profiled_prefill, prefill_s, f"{prefix}_prefill")
    logits, cache = held.pop("out")
    tok = logits[:, -1:, :V].argmax(dim=-1)
    del logits
    _profile(lambda: serve(params, cache, tok), decode_s / SERVE_GEN,
             f"{prefix}_decode")
    if cfg.family in ("ssm", "hybrid"):
        # the same weights in fp32 (bf16's are these, rounded)
        del params, cache, held
        gc.collect()
        torch.cuda.empty_cache()
        f32 = cfg.replace(dtype="float32")
        params = init_params(f32, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        agree = _serve_agreements(f32, params, toks, fed)
        emit({"phase": "serve_agreement", "path": name, "dtype": "float32",
              "limit": FP32_LOGIT_TOL, **agree})
        _check_agreements(f"{name} (fp32)", agree, FP32_LOGIT_TOL)
    return launches


# ------------------------------------------------------ LM training paths
# both paths: batch 8 x 512 tokens from synthetic_lm_batches (seed 1),
# random weights drawn on the card from seed 0, full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 3
# kernels on vs off after step 1 (the runs' losses are equal before the
# first update): |Δloss| / loss
TRAIN_LOSS_RTOL = 1e-2


def _bf16_order(t):
    """bf16 bits as integers in the order of the values (+0 = −0)."""
    import torch
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulp_gate(got, want):
    """(largest distance in bf16 steps, share of elements that differ)
    over two trees of bf16 leaves."""
    from repro_torch.tree import tree_flatten_with_path, tree_get
    worst, differ, n = 0, 0, 0
    for path, x in tree_flatten_with_path(got):
        dist = (_bf16_order(x) - _bf16_order(tree_get(want, path))).abs()
        worst = max(worst, int(dist.max()))
        differ += int((dist > 0).sum())
        n += x.numel()
    return worst, differ / n


def _train_run(cfg, step_fn, opt, name, steps):
    """``steps`` steps of ``step_fn`` from seed-0 weights on the card,
    each timed after ``torch.cuda.synchronize()``; launch counts set to
    0 just before the first step. Returns (params, opt_state, per-step
    records, launches, peak GB, the last batch)."""
    import torch
    from repro_torch.launch.train import device_batches, train
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    opt_state = opt.init(params)
    batches = list(device_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, steps,
                                  "cuda"))
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = [time.perf_counter()]

    def on_step(i, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - clock[0])
        clock[0] = now

    _zero_counts()
    params, opt_state, hist = train(step_fn, params, opt_state, batches,
                                    log_every=1, on_step=on_step,
                                    out=lambda line: None)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ntok = TRAIN_BATCH * TRAIN_SEQ
    recs = []
    for rec, wall in zip(hist, walls):
        rec = {**rec, "wall_ms": wall * 1e3, "tokens_per_s": ntok / wall}
        emit({"phase": "train_step", "run": name, **rec})
        if not all(math.isfinite(rec[k]) for k in ("loss_client",
                                                   "loss_server")):
            die(f"{name}: step {rec['step']} loss is not finite")
        recs.append(rec)
    return params, opt_state, recs, launches, peak_gb, batches[-1]


def phase_lm_train_path(arch):
    """Mamba2-2.7B at full width and depth trained by ``make_train_step``
    (bf16, remat, 4 microbatches, AdamW with the config's moment dtype)
    with the kernels on: Eq. 4 runs the ``fuse`` kernel on the bf16
    client gradients (4 launches a microbatch per client leaf) and no
    other kernel may launch (the scan records a gradient, so it takes
    ``ssd_chunked``). Gate on the kernel: the first microbatch's fused
    client gradient with the kernels on vs off within one bf16 ulp
    elementwise (and the losses equal). Then the same steps with the
    kernels off from the same weights: step-1 losses bit for bit, later
    ones within TRAIN_LOSS_RTOL; a profiled step."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import supernet as SN
    from repro_torch.core import tpgf as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batches
    from repro_torch.models.model import init_params, param_count
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).replace(use_pallas=True)
    d, mb = cfg.resolved_split_depth, cfg.microbatches
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n_params = param_count(params)
    batch = next(device_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 1, "cuda"))
    mb0 = {k: v[:TRAIN_BATCH // mb] for k, v in batch.items()}
    gate, gate_launches = {}, {}
    for label, on in (("on", True), ("off", False), ("off_again", False)):
        c = cfg.replace(use_pallas=on)
        client, server, local = SN.split_params(c, params, d)
        _zero_counts()
        out = T.tpgf_grads_split(c, c, client, server, local, mb0, d)
        torch.cuda.synchronize()
        gate_launches[label] = _counts()
        gate[label] = (out.g_client, float(out.loss_client),
                       float(out.loss_server), float(out.w_client))
        del out, client, server, local
    n_leaves = len(tree_leaves(gate["on"][0]))
    finite = all(bool(torch.isfinite(x).all()) for x in
                 tree_leaves(gate["on"][0])) and all(
        math.isfinite(v) for v in gate["on"][1:])
    if not finite:
        die("lm_train_path gate: the fused client gradient or a loss is "
            "not finite")
    worst, share = _ulp_gate(gate["on"][0], gate["off"][0])
    det_worst, det_share = _ulp_gate(gate["off"][0], gate["off_again"][0])
    same_losses = gate["on"][1:] == gate["off"][1:]
    emit({"phase": "lm_train_gate", "config": cfg.name,
          "split_depth": d, "client_leaves": n_leaves,
          "launches_kernels_on": gate_launches["on"],
          "losses_on": gate["on"][1:], "losses_off": gate["off"][1:],
          "losses_equal": same_losses,
          "fused_client_grad_max_bf16_ulps": worst,
          "fused_client_grad_share_differing": share,
          "plain_vs_plain_max_bf16_ulps": det_worst,
          "plain_vs_plain_share_differing": det_share})
    if gate_launches["on"]["fuse"] != n_leaves or any(
            v for k, v in gate_launches["on"].items() if k != "fuse"):
        die(f"lm_train_path gate: launches {gate_launches['on']}, expected "
            f"fuse {n_leaves} and nothing else")
    if not same_losses or worst > 1:
        die(f"lm_train_path gate: kernels on vs off: losses equal "
            f"{same_losses}, fused client gradient {worst} bf16 ulps apart")
    del gate, params
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for on in (True, False):
        c = cfg.replace(use_pallas=on)
        step_fn, opt = make_train_step(c)
        name = f"lm_train_path/{'kernels' if on else 'plain'}"
        params, opt_state, recs, launches, peak_gb, last = _train_run(
            c, step_fn, opt, name, TRAIN_STEPS)
        runs[on] = recs
        if on:
            want = {k: 0 for k in launches}
            want["fuse"] = TRAIN_STEPS * mb * n_leaves
            if launches != want:
                die(f"lm_train_path: {TRAIN_STEPS} steps launched "
                    f"{launches}, expected {want}")
            walls = [r["wall_ms"] for r in recs[1:]] or [recs[0]["wall_ms"]]
            wall_ms = statistics.median(walls)
            emit({"phase": "lm_train_path", "config": cfg.name,
                  **_config_fields(cfg), "dtype": cfg.dtype,
                  "params": n_params, "remat": cfg.remat,
                  "microbatches": mb, "split_depth": d,
                  "moment_dtype": cfg.adam_moment_dtype,
                  "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                  "steps": TRAIN_STEPS, "launches": launches,
                  "step_wall_ms": wall_ms,
                  "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
                  "peak_mem_gb": peak_gb})
            _profile(lambda: step_fn(params, opt_state, last),
                     wall_ms / 1e3, "lm_train")
        elif any(launches.values()):
            die(f"lm_train_path: kernels off launched {launches}")
        del params, opt_state, step_fn, opt, last
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    keys = ("loss_client", "loss_server", "w_client")
    step1_equal = all(on[0][k] == off[0][k] for k in keys)
    rel = [max(abs(a[k] - b[k]) / abs(b[k]) for k in keys)
           for a, b in zip(on[1:], off[1:])]
    emit({"phase": "agreement", "path": "lm_train_path",
          "step1_losses_equal": step1_equal,
          "later_steps_max_rel_diff": rel, "limit": TRAIN_LOSS_RTOL})
    if not step1_equal or any(r > TRAIN_LOSS_RTOL for r in rel):
        die(f"lm_train_path: kernels on vs off: step 1 equal "
            f"{step1_equal}, later steps {rel} (limit {TRAIN_LOSS_RTOL})")
    return {"fuse": TRAIN_STEPS * mb * n_leaves}


def phase_dense_train_path(arch):
    """Llama-3.2-3B at full width and depth trained through
    ``launch/train.py``'s config and loop (one microbatch, bf16, remat,
    ``adamw(1e-3)``) with the kernels off, as the reference can only
    train it: finite losses, no kernel launch, step wall, tokens/s, peak
    memory, a profiled step."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import param_count
    from repro_torch.optim import adamw
    cfg = train_config(arch, reduced=False)
    step_fn, opt = make_train_step(cfg, adamw(1e-3))
    params, opt_state, recs, launches, peak_gb, last = _train_run(
        cfg, step_fn, opt, "dense_train_path", TRAIN_STEPS)
    if any(launches.values()):
        die(f"dense_train_path: a kernel launched: {launches}")
    walls = [r["wall_ms"] for r in recs[1:]] or [recs[0]["wall_ms"]]
    wall_ms = statistics.median(walls)
    emit({"phase": "dense_train_path", "config": cfg.name,
          **_config_fields(cfg), "dtype": cfg.dtype,
          "params": param_count(params), "remat": cfg.remat,
          "microbatches": cfg.microbatches,
          "split_depth": cfg.resolved_split_depth, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches": launches,
          "step_wall_ms": wall_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
          "peak_mem_gb": peak_gb})
    _profile(lambda: step_fn(params, opt_state, last), wall_ms / 1e3,
             "dense_train")
    return launches


def _is_port_kernel(name: str) -> bool:
    """A profiler row of one of the port's CUDA kernels (``csrc/``)."""
    return any(f"(anonymous namespace)::{k}" in name for k in PORT_KERNELS)


def _profile(step, unprofiled_wall_s: float, path: str):
    """One more call of ``step`` (a round, a prefill) under
    torch.profiler: device time by kernel, and the device's idle share
    against the wall time of the same step unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
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
        (out / f"chip_smoke_profile_{path}.txt").write_text(
            averages.table(sort_by=attr, row_limit=60))
    unprofiled_ms = unprofiled_wall_s * 1e3
    port = [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
            for us, k, n in rows if _is_port_kernel(k)]
    emit({"phase": "profile", "path": path, "profiled_wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms,
          "unprofiled_wall_ms": unprofiled_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / unprofiled_ms),
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                  for us, k, n in rows[:15]],
          "port_kernels": port,
          "port_kernels_share_of_busy": (sum(r["device_ms"] for r in port)
                                         / busy_ms if busy_ms else 0.0)})


# ------------------------------------------------------------------- ncu
NCU_KERNELS = "flash_attention_bf16_kernel|ssd_scan_kernel"


def ncu_target(llama, ssm) -> None:
    """One launch of each kernel ``phase_ncu`` profiles, at its path's
    shape (``--ncu-target``; run under ``ncu`` only)."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.ssd_scan import ops as SO
    B.build(("flash_attention", "ssd_scan"))
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        b, s, h, k, d = llama
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        kv = torch.randn((b, s, k, d), generator=gen, device="cuda").bfloat16()
        FO.flash_attention(q, kv, kv, causal=True)
        b, s, nh, hd, st = ssm
        x = torch.randn((b, s, nh, hd), generator=gen, device="cuda")
        dt = torch.full((b, s, nh), 0.1, device="cuda")
        A = -torch.linspace(1.0, 16.0, nh, device="cuda")
        Bm = torch.randn((b, s, st), generator=gen, device="cuda")
        SO.ssd_scan(x, dt, A, Bm, Bm.flip(1).contiguous())
    torch.cuda.synchronize()


def phase_ncu():
    """``ncu --set full`` on one launch of each redesigned kernel at its
    path's shape, the report in the git-ignored results/, where the card's
    machine has ``ncu`` and lets it read the counters; otherwise the
    reason. Never fails the smoke: a profiler is not the program."""
    found = shutil.which("ncu")
    if found is None and Path("/usr/local/cuda/bin/ncu").exists():
        found = "/usr/local/cuda/bin/ncu"
    if found is None:
        emit({"phase": "ncu", "status": "ncu not found"})
        return
    out = ROOT / "results" / "chip_smoke_ncu"
    out.parent.mkdir(exist_ok=True)
    cmd = [found, "--set", "full", "-k", f"regex:{NCU_KERNELS}", "-c", "2",
           "-f", "-o", str(out), sys.executable, str(ROOT / "chip_smoke.py"),
           "--ncu-target"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)          # ncu and the target it started
        log, _ = proc.communicate()
        log += "\n(timed out after 300 s)"
    report = out.with_suffix(".ncu-rep")
    if proc.returncode != 0 or not report.exists():
        emit({"phase": "ncu", "status": f"ncu exited {proc.returncode}",
              "tail": log.strip().splitlines()[-4:]})
        return
    text = subprocess.run([found, "--import", str(report), "--page",
                           "details"], capture_output=True, text=True,
                          timeout=120).stdout
    (ROOT / "results" / "chip_smoke_ncu.txt").write_text(text)
    keys = ("Compute (SM) Throughput", "Memory Throughput",
            "Achieved Occupancy", "Bank Conflicts", "Warp Cycles Per Issued",
            "Registers Per Thread")
    emit({"phase": "ncu", "status": "ok", "report": str(report),
          "headline": [ln.strip() for ln in text.splitlines()
                       if any(k in ln for k in keys)][:40]})


# ------------------------------------------------------------------- main
def _largest_client_leaf(cfg):
    """The shape of the largest leaf of ``cfg``'s client view at its
    split depth (on the meta device: shapes only)."""
    from repro_torch.core.supernet import split_params
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves
    client = split_params(cfg, init_params(cfg, None, device="meta"),
                          cfg.resolved_split_depth)[0]
    return tuple(max(tree_leaves(client), key=lambda x: x.numel()).shape)


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        die(f"{SRC / 'repro_torch'} not found: run this script from the "
            "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    try:
        import torch  # noqa: F401
    except ImportError:
        die("torch is not installed")
    if "--ncu-target" in sys.argv[1:]:
        from repro_torch.configs.base import get_config
        lm, ssm = get_config(SERVE_ARCH), get_config(SSM_ARCH)
        ncu_target((SERVE_BATCH, SERVE_PROMPT, lm.n_heads, lm.n_kv_heads,
                    lm.resolved_head_dim),
                   (SERVE_BATCH, SERVE_PROMPT, ssm.ssm_n_heads,
                    ssm.ssm_head_dim, ssm.ssm_state))
        return
    phase_environment()
    import torch
    logs = phase_build()
    from repro_torch.configs.base import get_config
    from repro_torch.core.allocation import allocate_widths
    from repro_torch.federated.simulator import make_fleet
    cfg = get_config("vit16_cifar")
    fleet = make_fleet(cfg, 8, seed=0)
    d_max = int(fleet.depths.max())
    # the server rows of the shallowest mixed-width cohort: tier_sum's
    # largest leaf on the width path
    widths = allocate_widths([p.mem_gb for p in fleet.profiles], LADDER)
    d_mix = min(int(d) for d in set(fleet.depths.tolist())
                if len(set(widths[fleet.depths == d])) > 1)
    lm = get_config(SERVE_ARCH)
    ssm, hybrid = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    rows = [phase_fuse((d_max, cfg.d_model, cfg.d_ff),
                       _largest_client_leaf(ssm)),
            phase_aggregate(8, cfg.n_layers, cfg.d_model * cfg.d_ff),
            phase_tier_sum((cfg.n_layers - d_mix, cfg.d_model, cfg.d_ff)),
            phase_sumsq(cfg, d_max),
            phase_flash(*((SERVE_BATCH, SERVE_PROMPT, c.n_heads,
                           c.n_kv_heads, c.resolved_head_dim)
                          for c in (lm, hybrid)), logs["flash_attention"]),
            phase_ssd_scan(*((SERVE_BATCH, SERVE_PROMPT, c.ssm_n_heads,
                              c.ssm_head_dim, c.ssm_state)
                             for c in (ssm, hybrid)), logs["ssd_scan"])]
    torch.cuda.empty_cache()
    phase_ncu()
    launches = {}
    main_launches, eng = phase_path("main_path", ("fuse", "aggregate"))
    launches["main_path"] = main_launches
    launches["clip_path"] = phase_clip_path(cfg, eng.state.params, d_max)
    del eng
    torch.cuda.empty_cache()
    launches["width_path"] = phase_path(
        "width_path", ("fuse", "aggregate", "tier_sum"),
        width_tiers=LADDER, cross_tier="fused")[0]
    gc.collect()
    torch.cuda.empty_cache()
    # the paper's baselines: SplitFed aggregates through the aggregate
    # kernel, and nothing else of the port
    off_baseline = ("fuse", "tier_sum", "sumsq", "flash_attention",
                    "ssd_scan")
    baseline = {}
    for strategy in ("sfl", "dfl"):
        baseline[strategy] = phase_path(
            f"baseline_path_{strategy}", ("aggregate",), off_baseline,
            strategy=strategy)[0]
        gc.collect()
        torch.cuda.empty_cache()
    phase_fedavg_path()
    scenario = phase_scenario_path()
    phase_resume()
    gc.collect()                      # the ViT engines go before the LM
    torch.cuda.empty_cache()
    launches["serve_path"] = phase_serve_path(
        "serve_path", SERVE_ARCH, {"flash_attention": lm.n_layers})
    gc.collect()                      # the Llama weights go first
    torch.cuda.empty_cache()
    launches["ssm_serve_path"] = phase_serve_path(
        "ssm_serve_path", SSM_ARCH, {"ssd_scan": ssm.n_layers})
    gc.collect()
    torch.cuda.empty_cache()
    launches["hybrid_serve_path"] = phase_serve_path(
        "hybrid_serve_path", HYBRID_ARCH,
        {"flash_attention": hybrid.n_layers, "ssd_scan": hybrid.n_layers})
    gc.collect()                      # the serving weights go first
    torch.cuda.empty_cache()
    train_launches = {"lm_train_path": phase_lm_train_path(SSM_ARCH)}
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["dense_train_path"] = phase_dense_train_path(SERVE_ARCH)
    # each kernel's launches come from the path that carries it
    carried_by = {"fuse": "main_path", "aggregate": "main_path",
                  "tier_sum": "width_path", "sumsq": "clip_path",
                  "flash_attention": "serve_path",
                  "ssd_scan": "ssm_serve_path"}
    for row in rows:
        row["path"] = carried_by[row["name"]]
        row["launches"] = launches[row["path"]][row["name"]]
        row["also_on"] = {path: n[row["name"]] for path, n in scenario.items()
                          if n[row["name"]]}
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "also_on")
    # the hybrid path runs both serving kernels, and the baselines run
    # aggregate; their launches stand here
    emit({"hybrid_serve_path_launches": launches["hybrid_serve_path"]})
    emit({"baseline_path_launches": baseline})
    emit({"scenario_path_launches": scenario})
    emit({"train_path_launches": train_launches})
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    # hand the card's memory back before the result, so that the exit
    # after it has little left to tear down
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except BaseException:            # a traceback, then the same clean exit
        import traceback
        traceback.print_exc()
        end(1)
    end(0)
