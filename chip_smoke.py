#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, one JSON line each (plus the card's name and power limit as
``nvidia-smi`` prints them):

  1. environment — card, power limit, torch and CUDA versions; TF32 off;
  2. build — every CUDA kernel of the port, one ``nvcc`` per source, all
     started together, from ``src/repro_torch/csrc``;
  3. kernels — each kernel's wrapper (``fuse``, ``aggregate`` and its
     numerator mode ``aggregate_numerator``, ``tier_sum``, ``sumsq``,
     ``flash_attention``, ``ssd_scan``) against
     its plain PyTorch version on the card at the paths' shapes (and
     ragged, unaligned, zero-weight, windowed, MQA, every head dim, bf16,
     every (head_dim, state) pair, no-D and overflow cases), with times
     from CUDA events: kernel, plain version, one PyTorch library call
     where one computes the same function (none does for ``ssd_scan``),
     and the bound from ``repro_torch.roofline`` at ``kernel_shapes()``
     (bytes over 3.35 TB/s vs operations over the peak of their type: 67
     TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16);
     ``flash_attention`` and ``ssd_scan`` are timed at both of
     their paths' shapes and carry their ``ptxas`` registers and spills
     (``flash_attention`` also checked and timed at Mixtral-8x7B's
     windowed prefill shape, S 8,192 with window 4,096, its plain version
     at B 1 and SDPA with the window as a boolean mask, the kernel SDPA
     took named, at InternVL2-2B's and at Whisper-small's decoder
     prefill, 16 × 224 tokens, 12 heads of 64, multi-head),
     and ``fuse`` also in bf16 at the LM training path's largest client
     leaf (within one bf16 ulp; a ``kernel_bf16`` line);
     then, where the machine has ``ncu``, one ``ncu --set full`` profile
     of each at its path's shape (``--ncu-target`` is that profile's
     target, not a mode to run by hand);
  4. main path — full-width ViT-16-CIFAR trained by ``ssfl`` for two rounds
     through ``repro_torch.federated.Engine`` with the kernels on
     (``use_pallas=True``), then evaluated with the global head and the
     local ensemble; ``sumsq``, ``fuse`` and ``aggregate`` must launch.
     The same run with the kernels off, and TPGF's Phase 3 through the
     plain chain (on the card it runs ``sumsq`` and ``fuse`` whatever
     ``use_pallas`` says, here and on every TPGF path below), must agree
     (round losses and final parameters within 1e-4) and launch nothing.
     A profiled extra round reports device time by kernel; the path's line carries
     ``counted_flops`` (``count_flops`` of one round, on a copy of the
     engine) and ``mfu``, its share of the fp32 peak over the same
     round's wall, beside the card's name and limit;
  4a. fleet mesh path — the main path's fleet, seed and settings on a
     fleet mesh (``Engine(mesh=launch.mesh.make_fleet_mesh(R))``), two
     rounds, kernels on. One NCCL rank in this process: bit for bit the
     meshless run (losses, params, local heads), with the same launches.
     Two gloo ranks sharing the card, each this script started again
     (``--fleet-rank <r> <world> <backend> <dir>``, an internal mode like
     ``--ncu-target``; a ``file://`` store in a temporary directory, a
     120 s group timeout): losses and params within 1e-4 of the meshless run, the
     replicated state bit for bit on both ranks after each round, the
     ``fuse`` launches of the two ranks summing to the meshless run's,
     and each rank running Eq. 8 through ``aggregate_numerator`` as many
     times as the meshless run launches ``aggregate``; each rank's line
     carries its clients, round walls, peak memory, the bytes it
     all-reduced and the seconds its collectives took, beside the card's
     name and limit. A rank that cannot start on the card, a failed
     collective, a rank that exits non-zero: the run fails.
     ``python3 chip_smoke.py --fleet-nccl`` on a machine of several
     cards runs only this phase's multi-rank part, with one NCCL rank
     per card (the backend a deployment uses), held to the same gates,
     after the environment and build phases;
  5. width path — the same fleet on the width ladder (0.25, 0.5, 0.75,
     1.0) with ``cross_tier="fused"``: two mixed-width cohorts, so
     ``sumsq``, ``fuse``, ``aggregate`` and ``tier_sum`` must launch;
     kernels off must agree within 1e-4; both heads evaluate; a profiled round;
  6. clip path — ``fuse_tree(tau=0.5)`` (the Phase-1 clip fused into
     Eq. 4) over the depth-10 client's gradient shapes: ``sumsq`` and
     ``fuse`` must launch, and the result must match
     ``clip_by_global_l2`` + ``fuse_gradients`` (rtol 1e-4, atol 1e-6);
  6a. sanitize path — the main path's configuration with
     ``Engine(sanitize=True)``: three rounds sanitized and three not, on
     two engines of one seed, bit for bit (every loss, parameter and
     local head), ``fuse`` and ``aggregate`` launching in each sanitized
     round; both engines' device busy time (one profiled round each) and
     median wall of rounds 2-3, the sanitizer's price; NaN written into
     one client's rows of ``device_data.images`` must raise
     ``SlotSanitizerError`` with the client's cohort position among its
     slots, and a sample index past the flat dataset must raise "out of
     bounds" before any launch, after which a healthy round runs;
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
     two rounds each with the kernels on, then off with the plain Phase 3
     (within 1e-4, nothing launched): ``unstable`` at its defaults (Markov
     participation, staleness-weighted Eq. 6/8; ``sumsq``, ``fuse`` and
     ``aggregate`` must launch;
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
     times and rates, ``model_flops`` and ``mfu`` of a prefill and of a
     decode step (every serve path's line carries them, as every train
     path's line carries a step's), peak memory, the weights' init time,
     one profiled prefill and one profiled decode step;
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
 14. moe serve path — the same contract for Mixtral-8x7B at full width
     (d_model 4096, 32 query and 8 KV heads of 128, 8 experts of d_ff
     14336, top-2, dense dispatch), cut to 16 of its 32 layers (93.7 GB
     of bf16 weights do not fit one card), 2 prompts of 8,192 tokens,
     twice its 4,096-token sliding window: ``flash_attention`` must
     launch 16 times a prefill, every call with window 4,096; the cache
     must have 4,096 slots, each holding a position of its own residue,
     after the prefill and after decode; decode from an 8,160-token
     prefill runs the rolling cache against windowed flash. Its bf16
     agreements are held to ``BF16_LOGIT_TOL["moe"]``, and it prints the
     routing flips between kernels on and off, and between the 8,160-token
     prefill and the full one (the (token, layer) pairs whose top-2 set
     differs, by layer, with their margins; every margin into the
     git-ignored ``results/chip_smoke_flips_<config>_<dtype>.json``) and
     the prefill's summed router aux; the same agreements in fp32 at 4
     layers are held to ``FP32_LOGIT_TOL``, and no flip in the first layer
     where two runs route apart may lie above ``FP32_FLIP_MARGIN``;
 15. vlm serve path — InternVL2-2B whole (24 layers, d_model 2048, 16
     and 8 heads of 128) in bf16, 4 prompts of 256 seeded N(0, 1) image
     patches and 1,792 tokens: ``flash_attention`` 24 times a prefill,
     agreements within ``SERVE_LOGIT_TOL``, decode from 256 + 1,760
     positions;
 16. audio serve path — Whisper-small whole (12 encoder and 12 decoder
     layers, d_model 768, 12 heads of 64, gelu, layernorm; the decoder's
     head tied) in bf16, 16 requests of 1,500 seeded N(0, 1) frames and
     a 224-token decoder prompt: ``flash_attention`` 12 times a prefill
     (each decoder layer; the encoder's attention is not causal and the
     cross-attention is plain), agreements within
     ``BF16_LOGIT_TOL["audio"]``, the cross-attention cache
     ([12, 16, 1,500, 12, 64] keys and values) left by decode bit for
     bit, the same agreements in fp32 at full size within
     ``FP32_LOGIT_TOL``; it also prints the encoder's frames/s;
 17. moe train path — Mixtral-8x7B at full width, 2 layers (split depth
     1), through ``make_train_step`` with its config (bf16, remat, 4
     microbatches, AdamW with fp32 moments), 3 steps of 8 × 512 with the
     kernels off (flash has no backward): finite losses, the prefix's
     router aux finite and positive, ``sumsq`` and ``fuse`` once per
     client leaf and microbatch (Phase 3 on the card) and no other
     launch; step wall,
     tokens/s, peak memory, a profiled step. These phases' launches
     get a line each, their seconds a ``phase_time`` line each;
 18. audio train path — Whisper-small whole through ``launch/train.py``'s
     loop with its config (bf16, remat, AdamW with fp32 moments), 3 steps
     of 8 × 448 decoder tokens over zero frames, kernels off: finite
     losses, ``sumsq`` and ``fuse`` once per client leaf and no other
     launch, ``make_train_step`` refusing ``use_pallas=True``;
     step wall, tokens/s, peak memory, a profiled step;
 19. lm train path — Mamba2-2.7B at full width and depth trained by
     ``launch.steps.make_train_step`` with its config (bf16, remat, 4
     microbatches, AdamW with fp32 moments), 3 steps of 8 × 512 tokens
     from ``synthetic_lm_batches``, the serving weights freed first, with
     the kernels on: Phase 3 runs ``sumsq`` and ``fuse`` on the bf16
     client gradients, once each per client leaf and microbatch, and no
     other kernel may launch (the scan records a gradient, so it takes
     ``ssd_chunked``). The gate on the kernels: the first microbatch's
     fused client gradient (``sumsq`` and ``fuse``, one rounding) against
     the plain chain (``clip_by_global_l2``, then ``fuse_gradients``) on
     the same gradients, within the plain chain's extra rounding (one
     ulp of the result plus ``w`` times one of the clipped term), no
     farther in all from the fp32 Eq. 4, and the same bits on a second
     call. Then the same steps with the kernels off and Phase 3 through
     the plain chain, from the same weights, launching nothing: step-1
     losses bit for bit, later ones within ``TRAIN_LOSS_RTOL``. Step wall, tokens/s, peak memory,
     a profiled step;
 20. dense train path — Llama-3.2-3B at full width and depth trained
     through ``launch/train.py``'s config and loop (one microbatch,
     bf16, remat, ``adamw(1e-3)``) with the kernels off, 3 steps of
     8 × 512: finite losses, ``sumsq`` and ``fuse`` once per client leaf
     and no other launch, the same figures;
 21. lm mesh path — the LM families' sharded path (``models/sharded.py``)
     on a one-rank NCCL mesh of shape (1, 1) (``launch.mesh.
     make_test_mesh``), each against the meshless run of the same seed:
     Llama-3.2-3B whole, a prefill of 4 × 2,048 tokens and 8 decode steps
     fed the meshless run's tokens (``flash_attention`` 28 times, in each
     attention region's ``local_map``), then Mamba2-2.7B at 4 of its 64
     layers, a prefill (``ssd_scan`` 4 times) and a train step (``fuse``
     on the gradient shards, after the plain clip a sharded norm needs;
     the meshless step runs ``sumsq`` and ``fuse``, one rounding, so its
     parameters part from the mesh's by that rounding). Bit for bit is
     reported; the gates are the launch counts (``fuse`` and the flag's
     kernels equal) and the serve and train limits (``BF16_LOGIT_TOL``,
     ``TRAIN_LOSS_RTOL``). ``python3 chip_smoke.py
     --lm-mesh`` on a machine of four cards runs, after the environment
     and build phases, the one-card runs on card 0 and then one NCCL rank
     a card (the script started again, ``--lm-rank <r> <world> <dir>``,
     an internal mode like ``--fleet-rank``): (a) Mixtral-8x7B whole (32
     layers, bf16, seed 0) on ``make_test_mesh((1, 4))``, a prefill of 2
     × 8,192 tokens and 32 decode steps with the kernels on (windowed
     flash 32 times a prefill on each rank, at its 8 query and 2 kv
     heads), then off from the same weights (within
     ``BF16_LOGIT_TOL["moe"]``); at 16 layers against the one-card run
     (the same limit, decode fed its tokens); at 4 layers in fp32 within
     ``FP32_LOGIT_TOL``, with no routing flip above ``FP32_FLIP_MARGIN``
     in the first layer where the runs part; (b) Mamba2-2.7B trained on
     ``make_test_mesh((4, 1))`` (FSDP; one microbatch; 3 steps of 8 ×
     512; ``fuse`` on each rank's shards): losses within
     ``TRAIN_LOSS_RTOL`` of the one-card run, and at 4 layers in fp32
     trained by SGD within 1e-5, the parameters within 1e-4 (AdamW's
     first steps turn a near-zero gradient's flipped sign into 2·lr). Each rank's line carries
     its walls, peak memory, the bytes and calls of its collectives by
     kind and their seconds from issue to wait by CUDA events
     (``roofline.CollectiveCounter``, on one more prefill and train
     step), and rank 0's idle share; on one card it exits 1;
 22. the ``kernels`` summary line (seven rows: the six kernels and
     ``aggregate``'s numerator mode, whose launches are the fleet mesh
     path's, summed over its ranks); each kernel's ``launches`` come from
     the path named beside it (counts set to 0 just before that path;
     ``sumsq``'s from the main path's Phase 3), and ``also_on`` lists
     their launches on the clip path, the scenario paths, the moe, vlm
     and audio paths and the lm mesh path; the training paths'
     launches get a line of their own.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without it; so does a machine without a CUDA device, and a
directory that holds this script without the port beside it.
"""
from __future__ import annotations

import contextlib
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
ROUNDS = 2
# the sanitizer path's rounds per engine: the price is the median wall of
# rounds 2-3 (round 1 warms the allocator and cuBLAS)
SANITIZE_ROUNDS = 3
# what the run learned of its card (phase_environment): its name and power
# limit, as nvidia-smi prints them, stand beside every mfu
RUN = {}
LADDER = (0.25, 0.5, 0.75, 1.0)     # the width path's supernet tiers
PORT_KERNELS = ("fuse_kernel", "aggregate_kernel", "tier_sum_kernel",
                "sumsq_partial_kernel", "sumsq_final_kernel",
                "flash_attention_f32_kernel", "flash_attention_bf16_kernel",
                "ssd_cb_kernel", "ssd_scan_kernel")
SERVE_ARCH = "llama3_2_3b"
SSM_ARCH = "mamba2_2_7b"
HYBRID_ARCH = "hymba_1_5b"
MOE_ARCH = "mixtral_8x7b"
VLM_ARCH = "internvl2_2b"
AUDIO_ARCH = "whisper_small"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# Mixtral-8x7B's 32 layers are 93.7 GB in bf16, more than one 80 GB card:
# it serves 16 of them (47.2 GB); its fp32 gate takes 4 (24.8 GB) and its
# training path 2 (6.6 GB of weights, 26.4 GB of fp32 AdamW moments).
# Two prompts of 8,192 tokens: twice its 4,096-token window, so flash
# skips the tiles behind the window and the cache rolls, and 4 chunks of
# the moe's 4,096 tokens
MOE_SERVE_LAYERS, MOE_FP32_LAYERS, MOE_TRAIN_LAYERS = 16, 4, 2
MOE_SERVE_BATCH, MOE_SERVE_PROMPT = 2, 8192
# InternVL2-2B whole: 4 prompts of 256 image patches and 1,792 tokens
VLM_SERVE_TEXT = 1792
# Whisper-small whole: 16 requests, each a 30 s window of 1,500 encoder
# frames and a 224-token decoder prompt (the previous window's text, which
# Whisper conditions on), then 32 decode steps: 224 + 32 <= 448, its text
# context; it trains on 8 x 448 decoder tokens over zero frames
AUDIO_SERVE_BATCH, AUDIO_SERVE_PROMPT, AUDIO_TRAIN_SEQ = 16, 224, 448
# ssd_scan against its plain version: y and h within this much of their
# largest magnitude, the reference kernel's own bar (test_kernels.py)
SSD_TOL = 1e-4
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
# The moe family in bf16: a kernel-on/off difference of one ulp in an
# attention output can change a token's top-2 experts, and a changed
# expert moves that token's MLP output by O(1), which the next layers
# spread through attention. On the H100 at Mixtral's 16 layers, 2 ×
# 8,192 tokens, 2.2 % of the prefill's (token, layer) routings differ
# between kernels on and off, and the three bf16 agreements read 0.549
# (prefill), 0.201 (decode) and 0.243 (decode vs the teacher-forced
# prefill); the limit stands 37 % above the largest. In fp32 at 4 layers
# no routing differs and the agreements read 5.9e-7 to 9.5e-4: that is
# the gate on the kernel.
# The audio family in bf16 starts at the dense family's limit: its
# decoder runs 12 layers, flash in each, over a 12-layer encoder that
# both runs share (the encoder runs no kernel)
BF16_LOGIT_TOL = {"dense": SERVE_LOGIT_TOL, "vlm": SERVE_LOGIT_TOL,
                  "ssm": 0.2, "hybrid": 5e-2, "moe": 0.75,
                  "audio": SERVE_LOGIT_TOL}
FP32_LOGIT_TOL = 1e-3
# in fp32, where two runs of one model (kernels on and off, or the
# teacher-forced prefill against the full one) first route a token apart,
# only a near tie of the k-th and (k+1)-th router probabilities can have
# flipped; a flip in that layer at a larger margin than this is a fault
FP32_FLIP_MARGIN = 1e-5


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


def bound(work, dtype: str = "float32"):
    """``repro_torch.roofline``'s bound of ``work`` (its bytes and
    operations) at the peak of ``dtype``'s operations: (ms, "bytes" or
    "operations")."""
    from repro_torch.roofline import analysis as RF
    return RF.bound(*work, RF.HW.peak(dtype))


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
    RUN["card"] = card
    RUN["cards"] = smi.stdout.strip().splitlines()
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
    from repro_torch.roofline import analysis as RF
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
    bound_ms, bound_by = bound(RF.fuse_work(n))
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
    bf16["bound_ms"], bf16["bound_by"] = bound(RF.fuse_work(n, 2))
    emit({"phase": "kernel_bf16", **bf16})
    del a, b
    torch.cuda.empty_cache()
    return row


def phase_aggregate(n_clients, n_layers, feat):
    import torch
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    from repro_torch.roofline import analysis as RF
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
    bound_ms, bound_by = bound(RF.aggregate_work(N, Lk, F))
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


def phase_aggregate_numerator(n_clients, n_layers, feat):
    """The ``aggregate`` kernel's numerator mode (``sum_n ww c`` in fp32),
    which each rank of a fleet mesh runs on its own clients' rows, against
    its plain version; timed at a rank's share of the main path's fleet
    (``n_clients``), where ``torch.einsum`` computes the same function."""
    import torch
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    from repro_torch.roofline import analysis as RF
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        for N, Lk, F in ((n_clients, n_layers, feat), (5, 3, 1003),
                         (0, 3, 1003)):
            c = torch.randn((N, Lk, F), generator=gen, device=dev).to(dtype)
            ww = torch.rand((N, Lk), generator=gen, device=dev)
            key = f"{(N, Lk, F)}/{str(dtype)[6:]}"
            checks[key] = _check(f"aggregate_numerator {key}",
                                 O.aggregate_numerator(c, ww),
                                 R.numerator(c, ww), 1e-5, 1e-6)
            del c
    torch.cuda.synchronize()
    N, Lk, F = n_clients, n_layers, feat
    c = torch.randn((N, Lk, F), generator=gen, device=dev)
    ww = torch.rand((N, Lk), generator=gen, device=dev)
    ms = time_ms(lambda: O.aggregate_numerator(c, ww))
    plain_ms = time_ms(lambda: R.numerator(c, ww))
    library_ms = time_ms(lambda: torch.einsum("nl,nlf->lf", ww, c))
    bound_ms, bound_by = bound(RF.aggregate_numerator_work(N, Lk, F))
    row = {"name": "aggregate_numerator", "route": "cuda",
           "source": "src/repro_torch/csrc/layer_aggregate.cu",
           "replaces": "src/repro/kernels/layer_aggregate/kernel.py:34",
           "shape": [N, Lk, F], "dtype": "float32",
           "max_abs_err": checks[f"{(N, Lk, F)}/float32"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "torch.einsum('nl,nlf->lf', ww, c)"}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    del c
    torch.cuda.empty_cache()
    return row


def phase_tier_sum(shape):
    import torch
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    from repro_torch.roofline import analysis as RF
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
    bound_ms, bound_by = bound(RF.tier_sum_work(T, n))
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


def phase_sumsq(shape):
    import torch
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    from repro_torch.roofline import analysis as RF
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    checks = {}
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
    bound_ms, bound_by = bound(RF.sumsq_work(n))
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


def _top_device_kernel(call) -> str:
    """The name of the kernel that takes the most device time in one
    ``call()`` under torch.profiler: the backend a library call took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    if not len(averages):
        return "not measured: the profiler saw no kernel"
    attr = ("self_device_time_total"
            if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")
    top = max(averages, key=lambda ev: getattr(ev, attr, 0))
    return top.key[:100]


def phase_flash(shape, hybrid_shape, moe_shape, vlm_shape, audio_shape,
                build_log):
    """``flash_attention`` against its plain version on the card: the
    serve path's shape and Hymba's in bf16 and fp32, Mixtral's windowed
    shapes (S 8,192 and its teacher-forced 8,160, window 4,096, and one
    rank's 8 query and 2 kv heads of it on ``--lm-mesh``'s (1, 4) mesh),
    InternVL2's and Whisper's decoder (multi-head, head_dim 64, S 224),
    a window, MQA, every
    head dim, ragged S (one row past a tile), a window across tile edges,
    Sq = 1, Sq and Skv unequal, and non-causal cases; timed in bf16 at
    the serve path's shape and at Hymba's, Mixtral's, InternVL2's and
    Whisper's, each beside SDPA and its bound. ``moe_shape`` is (B, S,
    H, K, hd, window). At Mixtral's shape the plain version runs at B 1
    (its fp32
    [B, H, S, S] scores at B 2 would not fit beside their copies), and
    SDPA takes the window as a boolean mask; the kernel SDPA ran is named
    from a profiled call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    from repro_torch.roofline import analysis as RF
    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"
    B, S, H, K, hd = shape
    tols = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
    hb, hs, hh, hk, hhd = hybrid_shape
    mb, ms_moe, mh, mk, mhd, mwin = moe_shape
    vb, vs, vh, vk, vhd = vlm_shape
    ab, as_, ah, ak, ahd = audio_shape
    # (key, (B, Sq, Skv, H, K, hd), causal, window)
    cases = [(f"path/{B}x{S}x{H}x{K}x{hd}", (B, S, S, H, K, hd), True, 0),
             (f"hymba/{hb}x{hs}x{hh}x{hk}x{hhd}", (hb, hs, hs, hh, hk, hhd),
              True, 0),
             (f"mixtral/1x{ms_moe}x{mh}x{mk}x{mhd}/window{mwin}",
              (1, ms_moe, ms_moe, mh, mk, mhd), True, mwin),
             # the moe path's teacher-forced prefill: S not a whole tile
             (f"mixtral/1x{ms_moe - SERVE_GEN}x{mh}x{mk}x{mhd}/"
              f"window{mwin}", (1, ms_moe - SERVE_GEN, ms_moe - SERVE_GEN,
                                mh, mk, mhd), True, mwin),
             # one rank's heads of it on --lm-mesh's (1, 4) mesh
             (f"mixtral_rank/1x{ms_moe}x{mh // LM_MESH_RANKS}x"
              f"{mk // LM_MESH_RANKS}x{mhd}/window{mwin}",
              (1, ms_moe, ms_moe, mh // LM_MESH_RANKS, mk // LM_MESH_RANKS,
               mhd), True, mwin),
             (f"internvl2/{vb}x{vs}x{vh}x{vk}x{vhd}",
              (vb, vs, vs, vh, vk, vhd), True, 0),
             (f"whisper/{ab}x{as_}x{ah}x{ak}x{ahd}",
              (ab, as_, as_, ah, ak, ahd), True, 0),
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

        def timed(b, s, h, k, d, window=0, plain_b=None):
            """kernel, plain (at ``plain_b`` rows of the batch) and SDPA
            times, the bound's operations and bytes, SDPA's kernel."""
            q, kk, v = inputs(b, s, s, h, k, d, torch.bfloat16)
            ms = time_ms(lambda: O.flash_attention(q, kk, v, causal=True,
                                                   window=window))
            pb = plain_b or b
            qp, kp, vp = q[:pb], kk[:pb], v[:pb]
            big = pb * h * s * s * 4 > 2**32   # fp32 scores past 4 GiB
            plain_ms = time_ms(
                lambda: R.flash_attention_ref(qp, kp, vp, causal=True,
                                              window=window),
                **(dict(warmup=1, reps=2, samples=3) if big else {}))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, v))
            if window:
                rows = torch.arange(s, device=dev)[:, None]
                cols = torch.arange(s, device=dev)[None, :]
                mask = (cols <= rows) & (cols > rows - window)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
            library_ms = time_ms(sdpa)
            backend = _top_device_kernel(sdpa)
            nbytes, flops = RF.flash_work(b, s, h, k, d, window)
            return ms, plain_ms, library_ms, flops, nbytes, backend

        ms, plain_ms, library_ms, flops, nbytes, backend = timed(
            B, S, H, K, hd)
        h_ms, h_plain_ms, h_library_ms, h_flops, h_nbytes, _ = timed(
            *hybrid_shape)
        at_shapes = {}
        for label, args, kw in (
                ("mixtral", (mb, ms_moe, mh, mk, mhd),
                 dict(window=mwin, plain_b=1)),
                ("mixtral_rank", (mb, ms_moe, mh // LM_MESH_RANKS,
                                  mk // LM_MESH_RANKS, mhd),
                 dict(window=mwin, plain_b=1)),
                ("internvl2", vlm_shape, {}),
                ("whisper", audio_shape, {})):
            t = timed(*args, **kw)
            b_ms, b_by = bound((t[4], t[3]), "bfloat16")
            case = next(c for c in cases if c[0].startswith(label + "/"))
            at_shapes[label] = {
                "max_abs_err": {dt: checks[f"{case[0]}/{dt}"]
                                for dt in ("bfloat16", "float32")},
                "shape": list(args), "window": kw.get("window", 0),
                "ms": t[0], "plain_ms": t[1],
                "plain_batch": kw.get("plain_b") or args[0],
                "library_ms": t[2], "library_kernel": t[5],
                "bound_ms": b_ms, "bound_by": b_by,
                "gflop": t[3] / 1e9, "mbytes": t[4] / 1e6}
    bound_ms, bound_by = bound((nbytes, flops), "bfloat16")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
           "shape": [B, S, H, K, hd], "dtype": "bfloat16",
           "max_abs_err": checks[f"{cases[0][0]}/bfloat16"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "F.scaled_dot_product_attention(q, k, v "
                           "transposed to [B, H, S, hd] views, "
                           "is_causal=True, enable_gqa=True; with a "
                           "window, attn_mask = the causal window as "
                           "booleans)",
           "library_kernel": backend,
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "hybrid_shape": list(hybrid_shape), "hybrid_ms": h_ms,
           "hybrid_plain_ms": h_plain_ms,
           "hybrid_library_ms": h_library_ms,
           "hybrid_bound_ms": bound((h_nbytes, h_flops), "bfloat16")[0],
           "at_shapes": at_shapes,
           "ptxas": ptxas_figures(build_log, "flash_attention_bf16_kernel")}
    emit({"phase": "kernel", **row, "kernel_ms": ms, "checks": checks})
    return row


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
    from repro_torch.roofline import analysis as RF
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
    nbytes, flops = RF.ssd_work(*ssm_shape)
    bound_ms, bound_by = bound((nbytes, flops))
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
           "hybrid_bound_ms": bound(RF.ssd_work(*hybrid_shape))[0],
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
    from repro_torch.kernels.layer_aggregate.ops import aggregate_numerator
    return {"fuse": fuse_leaf, "aggregate": aggregate_leaf,
            "aggregate_numerator": aggregate_numerator,
            "tier_sum": tier_sum_leaf, "sumsq": sumsq_leaf,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


# TPGF's Phase 3 runs these on the card whatever ``use_pallas`` says
# (``core.tpgf.clip_and_fuse``); the flag selects every other kernel
PHASE3_KERNELS = ("sumsq", "fuse")


@contextlib.contextmanager
def _plain_phase3():
    """While inside, TPGF's Phase 3 takes the plain chain
    (``clip_by_global_l2``, then ``fuse_gradients`` under the step's
    flag), as it does off the card: a run with the kernels off then
    launches no kernel, and holds ``sumsq`` and ``fuse`` against the plain
    route too."""
    from repro_torch.core import tpgf as T
    inner = T.clip_and_fuse

    def plain(g_local, g_server, w, tau, *, use_pallas=False):
        clipped, _ = T.clip_by_global_l2(g_local, tau)
        return T.fuse_gradients(clipped, g_server, w, use_pallas=use_pallas)

    T.clip_and_fuse = plain
    try:
        yield
    finally:
        T.clip_and_fuse = inner


def _flag_counts(counts=None):
    """The launch counts of the kernels that ``use_pallas`` selects."""
    counts = _counts() if counts is None else counts
    return {k: v for k, v in counts.items() if k not in PHASE3_KERNELS}


def _check_train_launches(name, cfg, params, launches, steps):
    """A train path's launches: ``sumsq`` and ``fuse`` once each per
    non-empty client leaf and microbatch of ``steps`` steps, and no other
    kernel (flash has no backward, and a scan under autograd takes the
    plain version)."""
    from repro_torch.core.supernet import split_params
    from repro_torch.tree import tree_leaves
    client = split_params(cfg, params, cfg.resolved_split_depth)[0]
    n = steps * max(cfg.microbatches, 1) * sum(
        1 for x in tree_leaves(client) if x.numel())
    want = {k: n if k in PHASE3_KERNELS else 0 for k in launches}
    if launches != want:
        die(f"{name}: {steps} steps launched {launches}, expected {want}")


def phase_path(name, must_launch, forbidden=(), describe=None,
               same_round=False, count_flops=False, **engine_kw):
    """Train the fleet two rounds with the kernels on, every launch count
    set to 0 just before and read just after (each kernel of
    ``must_launch`` must have launched, none of ``forbidden``); then the
    same run with the kernels off and Phase 3 through the plain chain
    (``_plain_phase3``), which must launch nothing and agree within 1e-4;
    then a profiled round. ``describe(engine)`` adds entries to each
    round's line. ``same_round``: the profiled round's idle share
    is taken against the wall of the SAME round run unprofiled on a copy
    of the engine (a participation process gives every round other
    clients, so the last round's wall does not measure it).
    ``count_flops``: the path's line carries ``_round_flops``. Returns
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
    flops = _round_flops(eng) if count_flops else {}
    emit({"phase": name, "config": cfg.name, **flops,
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
    with _plain_phase3():
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


def _round_flops(eng):
    """``counted_flops``: ``repro_torch.roofline.count_flops`` of one round
    (every matmul of it, backward passes included), run on a copy of
    ``eng``; ``mfu``: those FLOPs over the wall of the same round run
    unprofiled on another copy, at the fp32 peak (the ViT's GEMMs run in
    fp32 with TF32 off). ``eng`` itself runs nothing."""
    import torch
    from repro_torch.roofline import analysis as RF
    timed, counted = copy.deepcopy(eng), copy.deepcopy(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed.run_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flops, _ = RF.count_flops(counted.run_round)
    del timed, counted
    torch.cuda.empty_cache()
    return {"counted_flops": flops, "counted_round_wall_ms": wall * 1e3,
            "mfu": RF.mfu(flops, wall, "float32"), "mfu_dtype": "float32",
            "card": RUN["card"]}


def _lm_flops(cfg, n_params, kind, seq, batch, wall_s):
    """``model_flops`` (``repro_torch.roofline``'s 6·N·D for a train step,
    2·N·D for a prefill or a decode step; N the active share of the live
    parameters) and ``mfu``: those FLOPs over ``wall_s`` at the peak of the
    dtype the step's GEMMs run in (the config's)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.roofline import analysis as RF
    flops = RF.model_flops(cfg, InputShape(kind, seq, batch, kind), n_params,
                           RF.active_params(cfg, n_params))
    return flops, RF.mfu(flops, wall_s, cfg.dtype)


def phase_sanitize_path():
    """The sanitizer on the main path's configuration (full-width
    ViT-16-CIFAR, 8 clients, ``ssfl``, kernels on): SANITIZE_ROUNDS rounds
    on an engine and on a sanitized engine of the same seed, in turns,
    bit for bit in every round's loss and in every parameter and local
    head; ``fuse`` and ``aggregate`` must launch in each sanitized round.
    The price: each engine's device busy time over one more profiled
    round, and the median wall of rounds 2-3. Then NaN written into one
    client's rows of ``device_data.images`` must raise
    ``SlotSanitizerError`` whose slots hold that client's cohort
    position (a fresh sanitized engine), and a poisoned sample index must
    raise "out of bounds" before any launch, after which a healthy round
    runs and launches the kernels. Any other outcome ends the run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.federated.sanitize import SlotSanitizerError
    from repro_torch.tree import tree_leaves

    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    engines = {"plain": _engine(cfg), "sanitized": _engine(cfg,
                                                            sanitize=True)}
    walls = {k: [] for k in engines}
    losses = {k: [] for k in engines}
    launches = []
    seconds = {}
    t_phase = time.perf_counter()
    for r in range(SANITIZE_ROUNDS):
        for label, eng in engines.items():
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = eng.run_round()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            losses[label].append(rec["loss"])
            if label == "sanitized":
                n = _counts()
                launches.append({k: n[k] for k in ("fuse", "aggregate")})
                if not all(launches[-1].values()):
                    die(f"sanitize_path: round {r + 1} sanitized launched "
                        f"{launches[-1]}")
    plain, checked = engines["plain"], engines["sanitized"]
    same_losses = losses["plain"] == losses["sanitized"]
    same_params = all(torch.equal(x, y) for tree in ("params", "local_heads")
                      for x, y in zip(tree_leaves(getattr(plain.state, tree)),
                                      tree_leaves(getattr(checked.state,
                                                          tree))))
    median = {k: statistics.median(v[1:]) for k, v in walls.items()}
    seconds["rounds"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    busy = {k: _profile(eng.run_round, median[k], f"sanitize_path_{k}",
                        host=False)
            for k, eng in engines.items()}
    seconds["profiles"] = time.perf_counter() - t_phase
    emit({"phase": "sanitize_path", "config": cfg.name,
          "clients": checked.state.n_clients, "rounds": SANITIZE_ROUNDS,
          "losses": losses, "losses_bit_for_bit": same_losses,
          "params_and_heads_bit_for_bit": same_params,
          "sanitized_launches": launches,
          "round_wall_ms": {k: [w * 1e3 for w in v]
                            for k, v in walls.items()},
          "median_wall_ms_rounds_2_3": {k: v * 1e3
                                        for k, v in median.items()},
          "device_busy_ms": busy,
          "busy_ratio": busy["sanitized"] / busy["plain"],
          "wall_ratio": median["sanitized"] / median["plain"],
          "seconds": seconds, "card": RUN["card"]})
    if not (same_losses and same_params):
        die(f"sanitize_path: sanitized rounds differ: losses equal "
            f"{same_losses}, params and heads equal {same_params}")
    del plain, engines
    gc.collect()
    torch.cuda.empty_cache()

    # an injected NaN: the rows of the last client of the shallowest
    # cohort of several clients (so its position is not 0)
    t_phase = time.perf_counter()
    poisoned = _engine(cfg, sanitize=True)
    cohort = next(c for c in poisoned.state.fleet.cohorts().values()
                  if len(c) > 1)
    client, position = int(cohort[-1]), len(cohort) - 1
    dd = poisoned.device_data
    lo = int(dd.offsets[client])
    dd.images[lo:lo + int(dd.sizes[client])] = float("nan")
    try:
        poisoned.run_round()
        die("sanitize_path: a NaN in a client's data did not trip")
    except SlotSanitizerError as exc:
        trip = exc
    emit({"phase": "sanitize_nan", "client": client,
          "cohort": cohort.tolist(), "position": position,
          "slots": list(trip.slots), "message": str(trip)[:300],
          "seconds": time.perf_counter() - t_phase})
    if position not in trip.slots or "cohort_kernel" not in str(trip):
        die(f"sanitize_path: NaN in client {client} (position {position}) "
            f"gave slots {trip.slots}: {trip}")
    del poisoned, dd, trip
    torch.cuda.empty_cache()

    # an out-of-bounds sample index: raised on the host before any launch
    orig = checked._sample_indices

    def past_the_end(ids, steps, batch_size=None):
        out = orig(ids, steps, batch_size)
        out[0, 0, 0] = int(checked.device_data.sizes.sum())
        return out

    checked._sample_indices = past_the_end
    _zero_counts()
    try:
        checked.run_round()
        die("sanitize_path: an out-of-bounds batch index did not trip")
    except SlotSanitizerError as exc:
        oob = str(exc)
    torch.cuda.synchronize()
    at_trip = _counts()
    checked._sample_indices = orig
    rec = checked.run_round()
    torch.cuda.synchronize()
    after = _counts()
    emit({"phase": "sanitize_oob", "message": oob,
          "launches_in_the_tripped_round": at_trip,
          "healthy_round_after": {"loss": rec["loss"],
                                  "launches": after}})
    if "out of bounds" not in oob or any(at_trip.values()) \
            or not math.isfinite(rec["loss"]) \
            or not (after["fuse"] and after["aggregate"]):
        die(f"sanitize_path: out of bounds: {oob!r}, launches in the "
            f"tripped round {at_trip}, the next round {rec['loss']} with "
            f"{after}")
    del checked
    gc.collect()
    torch.cuda.empty_cache()


FLEET_RANKS = 2
FLEET_TIMEOUT_S = 120       # each rank's process-group timeout


def _timed_rounds(eng, before=None, after=None):
    """``ROUNDS`` rounds: each one's record and wall, with ``before()``
    and ``after()`` (when given) around each, ``after``'s dict merged."""
    import torch
    out = []
    for _ in range(ROUNDS):
        if before:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = eng.run_round()
        torch.cuda.synchronize()
        rec = {"loss": rec["loss"], "wall_s": time.perf_counter() - t0}
        if not math.isfinite(rec["loss"]):
            die(f"fleet_mesh_path: a round's loss is {rec['loss']}")
        out.append({**rec, **(after() if after else {})})
    return out


def _fleet_state(eng):
    """(params, every client's heads) on the host."""
    from repro_torch.launch import sharding as SH
    from repro_torch.tree import tree_flatten_with_path
    heads = SH.fleet_gather(eng.state.local_heads, eng.state.n_clients,
                            eng.mesh)
    return ({p: x.detach().cpu() for p, x in
             tree_flatten_with_path(eng.state.params)},
            {p: x.detach().cpu() for p, x in tree_flatten_with_path(heads)})


def _fleet_rank(rank, world, backend, workdir):
    """One rank of a fleet mesh of ``world`` ranks (this script started
    again with ``--fleet-rank <r> <world> <backend> <workdir>``): gloo
    ranks share card 0, an NCCL rank takes card ``r``. Two kernel-on
    rounds of the main path's fleet; its figures to
    ``<workdir>/rank<r>.json``, rank 0's state to ``<workdir>/state.pt``.
    It prints nothing."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=FLEET_TIMEOUT_S))
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(world, device="cuda", backend=backend)
        eng = _engine(get_config("vit16_cifar").replace(use_pallas=True),
                      mesh=mesh)
        SH.time_collectives(True)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()

        def after():
            stats = SH.collective_stats(reset=True)
            return {"allreduced_bytes": stats["bytes"],
                    "collectives": stats["calls"],
                    "collective_s": stats["seconds"],
                    "replicated_drift": SH.replicated_drift(
                        (eng.state.params, eng.state.opt_state), mesh)}

        recs = _timed_rounds(eng, lambda: SH.collective_stats(reset=True),
                             after)
        launches = _counts()
        lo, hi = eng.state.rows
        out = {"rank": rank, "device": str(torch.cuda.current_device()),
               "clients": list(range(lo, hi)),
               "heads_rows": int(next(iter(
                   eng.state.local_heads.values())).shape[0]),
               "rounds": recs, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        params, heads = _fleet_state(eng)
        if rank == 0:
            torch.save({"params": params, "heads": heads},
                       os.path.join(workdir, "state.pt"))
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _fleet_meshless(cfg):
    """The meshless reference of the fleet paths: (rounds, launches,
    params, heads)."""
    import torch
    _zero_counts()
    eng = _engine(cfg)
    ref = _timed_rounds(eng)
    launches = _counts()
    params, heads = _fleet_state(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ref, launches, params, heads


def _fleet_ranks(world, backend, meshless):
    """``world`` ranks on ``backend``, each this script in a process of
    its own, every one waited for, held to the ``meshless`` run (module
    docstring, 4a); returns their launches summed over the ranks."""
    import tempfile
    import torch
    ref, ref_launches, ref_params, ref_heads = meshless
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        errs = [os.path.join(workdir, f"rank{r}.err") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(errs[r], "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--fleet-rank", str(r), str(world), backend,
                         workdir], cwd=ROOT,
                        stdout=subprocess.DEVNULL, stderr=err))
            for proc in procs:
                proc.wait(timeout=3 * FLEET_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [(r, proc.returncode) for r, proc in enumerate(procs)
                  if proc.returncode != 0]
        if failed:
            tails = {r: open(errs[r]).read()[-2000:] for r, _ in failed}
            die(f"fleet_mesh_path: ranks exited {failed}: {tails}")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        state = torch.load(os.path.join(workdir, "state.pt"))
    dloss = max(abs(a["loss"] - b["loss"]) for rk in ranks
                for a, b in zip(rk["rounds"], ref))
    dparam = max(float((state["params"][p] - x).abs().max())
                 for p, x in ref_params.items())
    dhead = max(float((state["heads"][p] - x).abs().max())
                for p, x in ref_heads.items())
    fuse_sum = sum(rk["launches"]["fuse"] for rk in ranks)
    cards = RUN.get("cards", [])[:world] if backend == "nccl" else \
        [RUN.get("card")]
    for rk in ranks:
        emit({"phase": "fleet_mesh_rank", "ranks": world,
              "backend": backend, "card": RUN.get("card"), **rk})
    line = {"phase": "fleet_mesh_path", "ranks": world,
            "backend": backend, "max_loss_diff": dloss,
            "max_param_diff": dparam, "max_head_diff": dhead,
            "fuse_launches": [rk["launches"]["fuse"] for rk in ranks],
            "meshless_fuse_launches": ref_launches["fuse"],
            "aggregate_numerator_launches": [
                rk["launches"]["aggregate_numerator"] for rk in ranks],
            "meshless_aggregate_launches": ref_launches["aggregate"],
            "meshless_rounds": ref, "spawn_s": spawn_s, "cards": cards}
    emit(line)
    drift = max(r["replicated_drift"] for rk in ranks for r in rk["rounds"])
    if dloss > 1e-4 or dparam > 1e-4 or dhead > 1e-4 or drift != 0.0:
        die(f"fleet_mesh_path: {world} ranks disagree with the meshless "
            f"run (loss {dloss}, params {dparam}, heads {dhead}) or with "
            f"each other (replicated drift {drift})")
    if fuse_sum != ref_launches["fuse"]:
        die(f"fleet_mesh_path: fuse launched {fuse_sum} times over the "
            f"ranks, the meshless run {ref_launches['fuse']}")
    for rk in ranks:
        n = rk["launches"]
        if n["fuse"] <= 0 or n["aggregate"] != 0 \
                or n["aggregate_numerator"] != ref_launches["aggregate"]:
            die(f"fleet_mesh_path: rank {rk['rank']} launched {n}")
    return {name: sum(rk["launches"][name] for rk in ranks)
            for name in ranks[0]["launches"]}


def phase_fleet_mesh_path():
    """The main path's fleet on a fleet mesh (module docstring, 4a)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_fleet_mesh
    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    meshless = _fleet_meshless(cfg)
    ref, ref_launches, ref_params, ref_heads = meshless

    # one NCCL rank, in this process: the meshless code path exactly
    mesh = make_fleet_mesh(1)
    _zero_counts()
    eng = _engine(cfg, mesh=mesh)
    one = _timed_rounds(eng)
    one_launches = _counts()
    params, heads = _fleet_state(eng)
    same = (all(a["loss"] == b["loss"] for a, b in zip(one, ref))
            and all(torch.equal(params[p], ref_params[p]) for p in params)
            and all(torch.equal(heads[p], ref_heads[p]) for p in heads))
    emit({"phase": "fleet_mesh_path", "ranks": 1, "backend":
          dist.get_backend(), "fleet_shards": eng.fleet_shards,
          "rounds": one, "meshless_rounds": ref, "bit_for_bit": same,
          "launches": one_launches, "meshless_launches": ref_launches,
          "card": RUN.get("card")})
    if not same or one_launches != ref_launches:
        die("fleet_mesh_path: a one-rank mesh is not the meshless run")
    if ref_launches["fuse"] <= 0 or ref_launches["aggregate"] <= 0:
        die(f"fleet_mesh_path: fuse and aggregate must launch "
            f"({ref_launches})")
    del eng
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    # two gloo ranks sharing the card (NCCL refuses two ranks on one)
    return _fleet_ranks(FLEET_RANKS, "gloo", meshless)


def phase_fleet_nccl():
    """``--fleet-nccl``: the main path's fleet on one NCCL rank per card
    of the machine (module docstring, 4a), held to the meshless run on
    card 0 as the two gloo ranks are."""
    import torch
    from repro_torch.configs.base import get_config
    world = torch.cuda.device_count()
    if world < 2:
        die(f"--fleet-nccl needs two cards or more, found {world}")
    cfg = get_config("vit16_cifar").replace(use_pallas=True)
    return _fleet_ranks(world, "nccl", _fleet_meshless(cfg))


# ------------------------------------------------------- LM mesh paths
# the one-card mesh path: Llama-3.2-3B's serve path at 8 decode steps,
# Mamba2-2.7B at 4 of its 64 layers
LM_MESH_DECODE, LM_MESH_SSM_LAYERS = 8, 4
LM_MESH_RANKS = 4
LM_MESH_TIMEOUT_S = 300     # each --lm-mesh rank's process-group timeout
# a mesh run keeps every LOGIT_STRIDE-th position's prefill logits to
# compare with another run (the full ones are [2, 8192, 32000])
LOGIT_STRIDE = 64
# --lm-mesh's fp32 training gates: the mesh against one card, trained by
# SGD (AdamW's first steps move each weight by about lr·sign(g), so a
# gradient near 0 whose sign the sums' order flips moves it by 2·lr: the
# parity tests take SGD for that reason)
MESH_FP32_LOSS_TOL, MESH_FP32_PARAM_TOL = 1e-5, 1e-4
MESH_FP32_SGD_LR = 0.1


def _whole(x):
    """A sharded result as the whole tensor on this rank."""
    from repro_torch.launch.sharding import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def _seeded(cfg, mesh=None):
    """``cfg``'s seed-0 weights on the card (this rank's shards on a
    mesh: every rank draws the meshless stream)."""
    import torch
    from repro_torch.models.model import init_params
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda", mesh=mesh)


def _mesh_serve(cfg, params, inputs, steps: int, fed=None):
    """A prefill of ``inputs`` and ``steps`` decode steps (fed the tokens
    ``fed`` [B, steps] when given, else greedy) through the steps' entry
    points (sharded parameters take the sharded path): (every
    LOGIT_STRIDE-th position's prefill logits, the decode logits [B,
    steps, V], the tokens decode took, prefill s, decode s)."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    prefill = make_prefill_step(cfg, decode_budget=steps)
    serve = make_serve_step(cfg)
    V = cfg.vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    logits = _whole(logits)
    tok = logits[:, -1:, :V].argmax(dim=-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sub = logits[:, ::LOGIT_STRIDE].float()
    del logits
    out, toks = [], []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(steps):
        if fed is not None:
            tok = fed[:, i:i + 1]
        toks.append(tok)
        lg, cache = serve(params, cache, tok)
        lg = _whole(lg)
        out.append(lg.float())
        tok = lg[:, :, :V].argmax(dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    return sub, torch.cat(out, 1), torch.cat(toks, 1), prefill_s, decode_s


def _host_params(params):
    """{path: the whole leaf in fp32 on the host} (shards gathered)."""
    from repro_torch.tree import tree_flatten_with_path
    return {p: _whole(x).detach().float().cpu()
            for p, x in tree_flatten_with_path(params)}


def _train_steps(cfg, params, batches, mesh=None, opt=None):
    """``make_train_step`` (``opt``; default its AdamW) over ``batches``,
    placed by ``batch_pspecs`` on a mesh: (params, each step's losses and
    wall)."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_train_step
    step, opt = make_train_step(cfg, opt)
    state = opt.init(params)
    recs = []
    for b in batches:
        if mesh is not None:
            b = SH.distribute_tree(b, SH.batch_pspecs(cfg, None, b, mesh),
                                   mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        recs.append({"loss_client": float(m["loss_client"]),
                     "loss_server": float(m["loss_server"]),
                     "wall_s": time.perf_counter() - t0})
    del state
    return params, recs


def _losses_close(got, want, rtol: float = 0.0, atol: float = 0.0):
    return all(abs(g[k] - w[k]) <= atol + rtol * abs(w[k])
               for g, w in zip(got, want)
               for k in ("loss_client", "loss_server"))


def phase_lm_mesh_path():
    """The LM families' sharded path on a one-rank NCCL mesh of shape
    (1, 1) (module docstring, 21): Llama-3.2-3B whole, a prefill of 4 ×
    2,048 tokens and 8 decode steps (28 flash launches a prefill, each in
    its attention region's ``local_map``), and Mamba2-2.7B at 4 layers, a
    prefill (4 ``ssd_scan`` launches) and a train step (``fuse`` on the
    gradient shards), each against the meshless run of the same seed: bit
    for bit expected, the serve and train limits the gate, the launch
    counts equal. Returns the mesh runs' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.launch.train import device_batches
    mesh = make_test_mesh((1, 1))
    out = {"phase": "lm_mesh_path", "mesh": "1x1",
           "backend": dist.get_backend(), "card": RUN.get("card")}

    cfg = get_config(SERVE_ARCH).replace(use_pallas=True)
    inputs = _serve_inputs(cfg, SERVE_BATCH, SERVE_PROMPT)
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        params = _seeded(cfg, m)
        _zero_counts()
        runs[name] = _mesh_serve(cfg, params, inputs, LM_MESH_DECODE,
                                 fed=runs["meshless"][2] if m else None)
        runs[name] += (_counts(),)
        del params
        torch.cuda.empty_cache()
    a, b = runs["meshless"], runs["mesh"]
    llama = {"prefill_ms": {k: r[3] * 1e3 for k, r in runs.items()},
             "decode_ms_per_step": {k: r[4] * 1e3 / LM_MESH_DECODE
                                    for k, r in runs.items()},
             "launches": {k: r[5] for k, r in runs.items()},
             "bit_for_bit": bool(torch.equal(a[0], b[0])
                                 and torch.equal(a[1], b[1])),
             "prefill_rel_diff": _rel_logit_diff(b[0], a[0]),
             "decode_rel_diff": _rel_logit_diff(b[1], a[1])}
    del runs, a, b
    cfg = get_config(SSM_ARCH).replace(use_pallas=True,
                                       n_layers=LM_MESH_SSM_LAYERS)
    inputs = _serve_inputs(cfg, SERVE_BATCH, SERVE_PROMPT)
    batches = list(device_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 1, "cuda"))
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        params = _seeded(cfg, m)
        _zero_counts()
        logits = _whole(make_prefill_step(cfg)(params, inputs)[0])
        served = _counts()
        _zero_counts()
        params, recs = _train_steps(cfg, params, batches, m)
        runs[name] = (logits[:, ::LOGIT_STRIDE].float(), recs, served,
                      _counts(), _host_params(params))
        del params, logits
        torch.cuda.empty_cache()
    a, b = runs["meshless"], runs["mesh"]
    dparam = max(float((b[4][p] - x).abs().max()) for p, x in a[4].items())
    losses = {k: [{n: v for n, v in rec.items() if n != "wall_s"}
                  for rec in r[1]] for k, r in runs.items()}
    mamba = {"layers": LM_MESH_SSM_LAYERS,
             "prefill_launches": {k: r[2] for k, r in runs.items()},
             "train_launches": {k: r[3] for k, r in runs.items()},
             "train": {k: r[1] for k, r in runs.items()},
             "bit_for_bit": bool(torch.equal(a[0], b[0]) and dparam == 0.0
                                 and losses["mesh"] == losses["meshless"]),
             "prefill_rel_diff": _rel_logit_diff(b[0], a[0]),
             "max_param_diff": dparam}
    del runs, a, b
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    emit({**out, "llama": llama, "mamba2": mamba})
    if llama["launches"]["mesh"] != llama["launches"]["meshless"] or \
            llama["launches"]["mesh"]["flash_attention"] != \
            get_config(SERVE_ARCH).n_layers:
        die(f"lm_mesh_path: Llama launched {llama['launches']}")
    pre, tr = mamba["prefill_launches"], mamba["train_launches"]
    # sharded gradients clip plainly and reach fuse through local_map;
    # the meshless step runs sumsq too
    if pre["mesh"] != pre["meshless"] or \
            _flag_counts(tr["mesh"]) != _flag_counts(tr["meshless"]) or \
            tr["mesh"]["fuse"] != tr["meshless"]["fuse"] or \
            tr["meshless"]["sumsq"] != tr["meshless"]["fuse"] or \
            pre["mesh"]["ssd_scan"] != LM_MESH_SSM_LAYERS or \
            tr["mesh"]["fuse"] <= 0:
        die(f"lm_mesh_path: Mamba2 launched {pre}, {tr}")
    if max(llama["prefill_rel_diff"], llama["decode_rel_diff"]) > \
            BF16_LOGIT_TOL["dense"] or \
            mamba["prefill_rel_diff"] > BF16_LOGIT_TOL["ssm"] or \
            not _losses_close(mamba["train"]["mesh"],
                              mamba["train"]["meshless"], TRAIN_LOSS_RTOL):
        die(f"lm_mesh_path: the mesh disagrees with the meshless run: "
            f"Llama {llama['prefill_rel_diff']}, "
            f"{llama['decode_rel_diff']}; Mamba2 "
            f"{mamba['prefill_rel_diff']}, {mamba['train']}")
    return {k: llama["launches"]["mesh"][k] + pre["mesh"][k] + tr["mesh"][k]
            for k in llama["launches"]["mesh"]}


def _probe_layers(sets, margins, n_layers):
    """A probe's prefill router calls, per layer (``_by_layer``)."""
    import types
    probe = types.SimpleNamespace(sets=sets, margins=margins)
    return _by_layer(probe, 0, len(sets), n_layers)


def _mesh_opt(key: str):
    """The optimizer of a ``--lm-mesh`` training run: the config's AdamW,
    SGD for the fp32 gate (see MESH_FP32_SGD_LR)."""
    from repro_torch.optim import sgd
    return sgd(MESH_FP32_SGD_LR) if key == "train_fp32" else None


def _lm_mesh_refs(workdir):
    """``--lm-mesh``'s one-card runs on card 0, before the ranks start:
    Mixtral at 4 layers in fp32 (a prefill, its routing) and at 16 in
    bf16 (a prefill and 32 greedy decode steps), Mamba2 whole in bf16
    and at 4 layers in fp32 by SGD (3 train steps each). Written to
    ``<workdir>/ref.pt`` (the fp32 Mamba2's final weights to
    ``ref_params.pt``); returns their walls."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.launch.train import device_batches
    ref, walls = {}, {}
    moe = get_config(MOE_ARCH).replace(use_pallas=True)
    inputs = _serve_inputs(moe, MOE_SERVE_BATCH, MOE_SERVE_PROMPT)
    cfg = moe.replace(dtype="float32", n_layers=MOE_FP32_LAYERS)
    params = _seeded(cfg)
    with _RouteProbe(True) as probe:
        logits = make_prefill_step(cfg)(params, inputs)[0]
    ref["fp32"] = (logits[:, ::LOGIT_STRIDE].float().cpu(),
                   [x.cpu() for x in probe.sets],
                   [x.cpu() for x in probe.margins])
    del params, logits, probe
    torch.cuda.empty_cache()
    params = _seeded(moe.replace(n_layers=MOE_SERVE_LAYERS))
    sub, steps, fed, pre_s, dec_s = _mesh_serve(
        moe.replace(n_layers=MOE_SERVE_LAYERS), params, inputs, SERVE_GEN)
    ref["bf16"] = (sub.cpu(), steps.cpu(), fed.cpu())
    walls["moe16_prefill_ms"] = pre_s * 1e3
    walls["moe16_decode_ms_per_step"] = dec_s * 1e3 / SERVE_GEN
    del params, sub, steps
    torch.cuda.empty_cache()
    ssm = get_config(SSM_ARCH).replace(use_pallas=True, microbatches=1)
    for key, cfg in (("train", ssm),
                     ("train_fp32", ssm.replace(dtype="float32",
                                                n_layers=LM_MESH_SSM_LAYERS))):
        batches = list(device_batches(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                      TRAIN_STEPS, "cuda"))
        params, ref[key] = _train_steps(cfg, _seeded(cfg), batches,
                                        opt=_mesh_opt(key))
        walls[f"{key}_step_ms"] = [r["wall_s"] * 1e3 for r in ref[key]]
        if key == "train_fp32":
            torch.save(_host_params(params),
                       os.path.join(workdir, "ref_params.pt"))
        del params, batches
        torch.cuda.empty_cache()
    torch.save(ref, os.path.join(workdir, "ref.pt"))
    return walls


def _lm_mesh_rank(rank, world, workdir):
    """One NCCL rank of ``--lm-mesh`` (this script started again with
    ``--lm-rank <r> <world> <workdir>``), on card ``r``: (a) Mixtral-8x7B
    on ``make_test_mesh((1, world))``, (b) Mamba2-2.7B training on
    ``make_test_mesh((world, 1))`` (module docstring). Its figures go to
    ``<workdir>/rank<r>.json``, rank 0's compared tensors to
    ``<workdir>/mesh.pt``. It prints nothing."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=LM_MESH_TIMEOUT_S))
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.launch.train import device_batches
        from repro_torch.roofline import CollectiveCounter
        ref = torch.load(os.path.join(workdir, "ref.pt"))
        res, keep = {"rank": rank}, {}
        mesh = make_test_mesh((1, world))
        moe = get_config(MOE_ARCH).replace(use_pallas=True)
        inputs = _serve_inputs(moe, MOE_SERVE_BATCH, MOE_SERVE_PROMPT)
        ntok = MOE_SERVE_BATCH * MOE_SERVE_PROMPT
        cfg = moe.replace(dtype="float32", n_layers=MOE_FP32_LAYERS)
        params = _seeded(cfg, mesh)
        with _RouteProbe(True) as probe:
            logits = _whole(make_prefill_step(cfg)(params, inputs)[0])
        keep["fp32"] = (logits[:, ::LOGIT_STRIDE].float().cpu(),
                        [x.cpu() for x in probe.sets],
                        [x.cpu() for x in probe.margins])
        del params, logits, probe
        torch.cuda.empty_cache()
        cfg = moe.replace(n_layers=MOE_SERVE_LAYERS)
        params = _seeded(cfg, mesh)
        sub, steps, _, _, _ = _mesh_serve(cfg, params, inputs, SERVE_GEN,
                                          fed=ref["bf16"][2].to("cuda"))
        keep["bf16"] = (sub.cpu(), steps.cpu())
        del params, sub, steps
        torch.cuda.empty_cache()
        # Mixtral whole: kernels on, then off from the same weights
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = _seeded(moe, mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _zero_counts()
        on = _mesh_serve(moe, params, inputs, SERVE_GEN)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        prefill = make_prefill_step(moe)
        # the collectives' bytes, and their time from issue to wait by
        # CUDA events, of one more prefill (the counting mode's dispatch
        # costs host time, so the walls above ran without it)
        with CollectiveCounter(timed=True) as prefill_cc:
            prefill(params, inputs)
        busy = None
        if rank == 0:
            busy = _profile(lambda: prefill(params, inputs), on[3],
                            "lm_mesh_moe_prefill")
        else:                   # the same collectives as rank 0's
            prefill(params, inputs)
        # kernels off, the same collectives: counted over prefill + decode
        with CollectiveCounter(timed=True) as serve_cc:
            off = _mesh_serve(moe.replace(use_pallas=False), params, inputs,
                              SERVE_GEN, fed=on[2])
        res["moe"] = {
            "layers": moe.n_layers, "init_s": init_s,
            "prefill_ms": on[3] * 1e3, "prefill_tokens_per_s": ntok / on[3],
            "decode_ms_per_step": on[4] * 1e3 / SERVE_GEN,
            "decode_tokens_per_s": MOE_SERVE_BATCH * SERVE_GEN / on[4],
            "launches": launches, "peak_mem_gb": peak,
            "prefill_collectives": prefill_cc.summary(),
            "serve_collectives_kernels_off": serve_cc.summary(),
            "prefill_device_busy_ms": busy,
            "prefill_idle_share": (None if busy is None else
                                   max(0.0, 1 - busy / (on[3] * 1e3))),
            "kernels_on_vs_off": {
                "prefill": _rel_logit_diff(on[0], off[0]),
                "decode": _rel_logit_diff(on[1], off[1])},
            "generated_req0": on[2][0, :8].tolist()}
        del params, on, off
        torch.cuda.empty_cache()
        # (b) Mamba2 training, FSDP over the ranks
        mesh = make_test_mesh((world, 1))
        ssm = get_config(SSM_ARCH).replace(use_pallas=True, microbatches=1)
        for key, cfg in (("train", ssm),
                         ("train_fp32", ssm.replace(
                             dtype="float32",
                             n_layers=LM_MESH_SSM_LAYERS))):
            batches = list(device_batches(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                          TRAIN_STEPS, "cuda"))
            params = _seeded(cfg, mesh)
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            params, recs = _train_steps(cfg, params, batches, mesh,
                                        _mesh_opt(key))
            res[key] = {"steps": recs, "launches": _counts(),
                        "step_tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ
                                              / r["wall_s"] for r in recs],
                        "peak_mem_gb": torch.cuda.max_memory_allocated()
                        / 2**30}
            if key == "train":
                # one more step (a fresh AdamW state), counted
                with CollectiveCounter(timed=True) as cc:
                    params = _train_steps(cfg, params, batches[:1], mesh)[0]
                res[key]["step_collectives"] = cc.summary()
            else:
                got = _host_params(params)      # every rank gathers
                if rank == 0:
                    want = torch.load(os.path.join(workdir,
                                                   "ref_params.pt"))
                    res[key]["max_param_diff"] = max(
                        float((got[p] - x).abs().max())
                        for p, x in want.items())
                del got
            del params, batches
            torch.cuda.empty_cache()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if rank == 0:
            torch.save(keep, os.path.join(workdir, "mesh.pt"))
    finally:
        dist.destroy_process_group()


def phase_lm_mesh_cards():
    """``--lm-mesh``: Mixtral-8x7B whole served and Mamba2-2.7B trained
    over one NCCL rank per card of a four-card machine, held to the
    one-card runs on card 0 (module docstring). Returns the launches
    summed over the ranks."""
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    world = torch.cuda.device_count()
    if world < LM_MESH_RANKS:
        die(f"--lm-mesh needs {LM_MESH_RANKS} cards, found {world}")
    world = LM_MESH_RANKS
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        walls = _lm_mesh_refs(workdir)
        gc.collect()
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t0
        errs = [os.path.join(workdir, f"rank{r}.err") for r in range(world)]
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(world):
                with open(errs[r], "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--lm-rank", str(r), str(world), workdir], cwd=ROOT,
                        stdout=subprocess.DEVNULL, stderr=err))
            for proc in procs:
                proc.wait(timeout=2 * LM_MESH_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode != 0]
        if failed:
            tails = {r: open(errs[r]).read()[-3000:] for r, _ in failed}
            die(f"lm_mesh: ranks exited {failed}: {tails}")
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ref = torch.load(os.path.join(workdir, "ref.pt"))
        mesh = torch.load(os.path.join(workdir, "mesh.pt"))
    cards = RUN.get("cards", [])[:world]
    for rk in ranks:
        emit({"phase": "lm_mesh_rank", "ranks": world,
              "card": cards[rk["rank"]] if rk["rank"] < len(cards)
              else RUN.get("card"), **rk})
    flips, _ = _flips(_probe_layers(*ref["fp32"][1:], MOE_FP32_LAYERS),
                      _probe_layers(*mesh["fp32"][1:], MOE_FP32_LAYERS))
    gates = {
        "moe_fp32_prefill": _rel_logit_diff(mesh["fp32"][0], ref["fp32"][0]),
        "moe_fp32_flips": flips,
        "moe_bf16_16_prefill": _rel_logit_diff(mesh["bf16"][0],
                                               ref["bf16"][0]),
        "moe_bf16_16_decode": _rel_logit_diff(mesh["bf16"][1],
                                              ref["bf16"][1]),
        "moe_32_on_vs_off": ranks[0]["moe"]["kernels_on_vs_off"],
        "train_losses": [r["train"]["steps"] for r in ranks],
        "train_losses_one_card": ref["train"],
        "train_fp32_losses": ranks[0]["train_fp32"]["steps"],
        "train_fp32_losses_one_card": ref["train_fp32"],
        "train_fp32_max_param_diff": ranks[0]["train_fp32"][
            "max_param_diff"]}
    emit({"phase": "lm_mesh_cards", "ranks": world, "cards": cards,
          "one_card": walls, "refs_s": refs_s, "ranks_s": ranks_s,
          "limits": {"moe_bf16": BF16_LOGIT_TOL["moe"],
                     "moe_fp32": FP32_LOGIT_TOL,
                     "flip_margin": FP32_FLIP_MARGIN,
                     "train_rtol": TRAIN_LOSS_RTOL,
                     "train_fp32_loss": MESH_FP32_LOSS_TOL,
                     "train_fp32_param": MESH_FP32_PARAM_TOL}, **gates})
    moe_bad = (gates["moe_fp32_prefill"] > FP32_LOGIT_TOL
               or (flips["first_layer_max_margin"] or 0) > FP32_FLIP_MARGIN
               or max(gates["moe_bf16_16_prefill"],
                      gates["moe_bf16_16_decode"],
                      *gates["moe_32_on_vs_off"].values())
               > BF16_LOGIT_TOL["moe"])
    if moe_bad:
        die("lm_mesh: Mixtral on the mesh disagrees (see the lm_mesh_cards "
            "line)")
    if not all(_losses_close(r["train"]["steps"], ref["train"],
                             TRAIN_LOSS_RTOL) for r in ranks) or \
            not _losses_close(gates["train_fp32_losses"], ref["train_fp32"],
                              atol=MESH_FP32_LOSS_TOL) or \
            gates["train_fp32_max_param_diff"] > MESH_FP32_PARAM_TOL:
        die("lm_mesh: Mamba2 training on the mesh disagrees (see the "
            "lm_mesh_cards line)")
    layers = get_config(MOE_ARCH).n_layers
    for rk in ranks:
        if rk["moe"]["launches"]["flash_attention"] != layers or \
                rk["train"]["launches"]["fuse"] <= 0:
            die(f"lm_mesh: rank {rk['rank']} launched {rk['moe']['launches']}"
                f", {rk['train']['launches']}")
    return {k: sum(rk["moe"]["launches"][k] + rk["train"]["launches"][k]
                   for rk in ranks) for k in ranks[0]["moe"]["launches"]}


def phase_clip_path(cfg, params, d):
    """``fuse_tree(tau=0.5)`` on the depth-``d`` client's gradient shapes
    (random trees, the clipped one scaled to a norm near 1 so the clip
    scale is near 0.5): ``sumsq`` and ``fuse`` must launch, and the result
    must match ``clip_by_global_l2`` + ``fuse_gradients``."""
    import torch
    from repro_torch.core import tpgf as T
    from repro_torch.core.supernet import split_params
    from repro_torch.kernels.tpgf_fusion import ops as O
    from repro_torch.roofline import analysis as RF
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
    sumsq_tree_bound_ms, _ = bound(RF.sumsq_work(n))
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
    off_path = ("flash_attention", "ssd_scan")
    for name, must, describe, kw in (
            ("unstable", ("sumsq", "fuse", "aggregate"), _staleness_line,
             dict(strategy="unstable")),
            ("async_buffered", ("sumsq", "fuse", "aggregate"), _buffer_line,
             dict(strategy=_async_fedadam)),
            ("hasfl", ("sumsq", "fuse", "aggregate", "tier_sum"),
             _tuned_line,
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
    """The widths a serve or train line reports for ``cfg``'s family."""
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab}
    if cfg.family in ("dense", "moe", "vlm", "hybrid", "audio"):
        out.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                   sliding_window=cfg.sliding_window)
    if cfg.is_encdec:
        out.update(n_enc_layers=cfg.n_enc_layers, enc_frames=cfg.enc_frames,
                   mlp=cfg.mlp, norm=cfg.norm)
    if cfg.family == "moe":
        out.update(n_experts=cfg.n_experts, top_k=cfg.top_k,
                   moe_dispatch=cfg.moe_dispatch)
    if cfg.family == "vlm":
        out.update(n_patches=cfg.n_patches)
    if cfg.family in ("ssm", "hybrid"):
        out.update(ssm_d_inner=cfg.ssm_d_inner, ssm_n_heads=cfg.ssm_n_heads,
                   ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    return out


def _n_patches(cfg) -> int:
    """Positions before the text: a vlm prompt's image patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _serve_inputs(cfg, batch: int, prompt: int):
    """A serve path's prompts on the card: ``tokens`` [batch, prompt] from
    ``synthetic_lm_batches`` (seed 1) and, for vlm, ``patches`` [batch,
    n_patches, d_model], for audio ``frames`` [batch, enc_frames,
    d_model], drawn N(0, 1) from seed 2 in the config's dtype."""
    import torch
    from repro_torch.data.synthetic import synthetic_lm_batches
    from repro_torch.models.model import side_input_shapes, torch_dtype
    b = next(synthetic_lm_batches(cfg.vocab, prompt, batch, 1, seed=1))
    out = {"tokens": torch.as_tensor(b["tokens"], device="cuda").long()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, shape in side_input_shapes(cfg, batch).items():
        out[name] = torch.randn(shape, generator=gen,
                                device="cuda").to(torch_dtype(cfg))
    return out


class _RouteProbe:
    """While active (and ``on``), records each call of the port's moe
    router and layer: every token's top-k expert set (sorted), its
    routing margin (the k-th largest probability minus the (k+1)-th), and
    each layer's router aux. The module's functions are restored on
    exit. Used only to compare two runs, never on a timed one."""

    def __init__(self, on: bool):
        self.on = on
        self.sets, self.margins, self.aux = [], [], []

    def __enter__(self):
        if not self.on:
            return self
        from repro_torch.models import moe as MOE
        self._mod, self._route, self._apply = MOE, MOE.route, MOE.moe_apply

        def route(cfg, p, xt):
            probs, topv, topi = self._route(cfg, p, xt)
            top = probs.topk(cfg.top_k + 1, dim=-1).values
            self.sets.append(topi.sort(dim=-1).values)
            self.margins.append(top[:, -2] - top[:, -1])
            return probs, topv, topi

        def moe_apply(cfg, p, x):
            y, aux = self._apply(cfg, p, x)
            self.aux.append(aux.detach())
            return y, aux

        MOE.route, MOE.moe_apply = route, moe_apply
        return self

    def __exit__(self, *exc):
        if self.on:
            self._mod.route, self._mod.moe_apply = self._route, self._apply

    def mark(self):
        """(router calls, layer calls) so far; the first mark is the
        prefill's end."""
        self.n_prefill = len(self.sets)
        return len(self.sets), len(self.aux)


# the first flipping layer's margins a line prints (the largest first);
# every flip's margin goes to results/chip_smoke_flips_<path>.json
FLIP_MARGINS_SHOWN = 64
# the decades of a margin histogram: < 1e-7, [1e-7, 1e-6), ..., >= 1e-1
MARGIN_DECADES = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


def _by_layer(probe, lo, hi, n_layers, step_major=False):
    """The router calls [lo, hi) of a probe, per layer: (sets [T, k],
    margins [T]) over the tokens in call order. A prefill calls each
    layer's chunks in turn (layer-major); decode calls every layer once a
    step (``step_major``)."""
    import torch
    calls = list(range(lo, hi))
    per = len(calls) // n_layers
    out = []
    for layer in range(n_layers):
        idx = (calls[layer::n_layers] if step_major
               else calls[layer * per:(layer + 1) * per])
        out.append((torch.cat([probe.sets[i] for i in idx]),
                    torch.cat([probe.margins[i] for i in idx])))
    return out


def _histogram(margins):
    counts = [0] * (len(MARGIN_DECADES) + 1)
    for m in margins:
        counts[sum(m >= d for d in MARGIN_DECADES)] += 1
    return counts


def _flips(a_layers, b_layers):
    """Routing flips between two runs over the same tokens, per layer:
    the (token, layer) pairs whose top-k set differs, and each flip's
    margin (the larger of the two runs' margins). Up to the first layer
    with a flip the runs differ by rounding alone, so that layer's
    margins say how near a tie the rounding found; a later flip also
    follows from the O(1) change an earlier one made to its token, which
    attention spreads to the tokens after it."""
    by_layer, every, first = [], [], None
    for layer, ((sa, ma), (sb, mb)) in enumerate(zip(a_layers, b_layers)):
        diff = (sa != sb).any(dim=-1)
        m = sorted(ma.maximum(mb)[diff].tolist(), reverse=True)
        by_layer.append(len(m))
        every += m
        if m and first is None:
            first = (layer, m)
    every.sort(reverse=True)
    return {"flips": len(every),
            "routed": sum(sa.shape[0] for sa, _ in a_layers),
            "flips_by_layer": by_layer,
            "first_flip_layer": first[0] if first else None,
            "first_layer_max_margin": first[1][0] if first else None,
            "first_layer_margins": (first[1][:FLIP_MARGINS_SHOWN]
                                    if first else []),
            "max_margin": every[0] if every else None,
            "margin_decades": _histogram(every)}, every


def _routing(name, a, b, n_pre, n_layers):
    """Routing flips between the kernels-on probe ``a`` and the -off
    probe ``b``, in the prefill (the first ``n_pre`` router calls) and in
    decode, and the summed router aux of ``a``'s prefill. Every flip's
    margin is written to results/."""
    out, every = {}, {}
    for part, (lo, hi), major in (("prefill", (0, n_pre[0]), False),
                                  ("decode", (n_pre[0], len(a.sets)), True)):
        summary, every[part] = _flips(
            _by_layer(a, lo, hi, n_layers, major),
            _by_layer(b, lo, hi, n_layers, major))
        out.update({f"{part}_{k}": v for k, v in summary.items()})
    out["prefill_router_aux_sum"] = float(sum(x.float()
                                              for x in a.aux[:n_pre[1]]))
    res = ROOT / "results"
    res.mkdir(exist_ok=True)
    (res / f"chip_smoke_flips_{name}.json").write_text(json.dumps(
        {"decades": MARGIN_DECADES, **every}))
    return out


def _tf_flips(full, tf, batch, S, n0, n_layers):
    """Routing flips between the full prefill (probe ``full``, its first
    router calls) and the prefill of the first ``n0`` tokens (probe
    ``tf``) over the positions both saw."""
    def shared(probe, calls, s):
        return [(x.reshape(batch, s, -1)[:, :n0].reshape(batch * n0, -1),
                 m.reshape(batch, s)[:, :n0].reshape(-1))
                for x, m in _by_layer(probe, 0, calls, n_layers)]
    summary, _ = _flips(shared(full, full.n_prefill, S),
                        shared(tf, len(tf.sets), n0))
    return {f"teacher_forced_prefill_{k}": v for k, v in summary.items()}


def _cache_fields(name, cfg, cache):
    """The cache's slots after a prefill or decode: W slots, slot s
    holding a position p with p % W == s; once the positions pass the
    config's sliding window, W is that window and the slots hold the last
    W positions. Dies otherwise."""
    import torch
    pos, idx = cache["pos"], int(cache["idx"])
    W = pos.shape[1]
    filled = pos >= 0
    slots = torch.arange(W, device=pos.device)
    ok = bool(((pos % W == slots) | ~filled).all())
    win = cfg.sliding_window
    wrapped = bool(win) and idx > win
    if wrapped:
        ok = ok and W == win and bool(filled.all()) and \
            int(pos.max()) == idx - 1 and int(pos.min()) == idx - W
    if not ok:
        die(f"{name}: the cache at idx {idx} does not hold position "
            f"% {W} in each slot (window {win})")
    out = {"slots": W, "idx": idx, "wrapped": wrapped,
           "pos_min": int(pos[filled].min()), "pos_max": int(pos.max())}
    for key in ("cross_k", "cross_v"):
        if key in cache:
            out[key] = list(cache[key].shape)
    return out


class _FlashWindows:
    """Records (Sq, window) of every ``flash_attention`` call the model
    makes while active: the model module's handle on the kernel's ops
    module is swapped for a recording one (the real wrapper still runs
    and counts its launches)."""

    def __enter__(self):
        import types
        from repro_torch.models import model as M
        self._M, self._FA = M, M.FA
        real = M.FA.flash_attention
        self.calls = []

        def flash_attention(q, k, v, *, causal=True, window=0):
            self.calls.append((q.shape[1], window))
            return real(q, k, v, causal=causal, window=window)

        M.FA = types.SimpleNamespace(flash_attention=flash_attention)
        return self

    def __exit__(self, *exc):
        self._M.FA = self._FA


def _serve_agreements(cfg, params, inputs, fed):
    """Kernels on vs off — the prefill logits, and decode steps fed the
    tokens ``fed`` (greedy argmax over random weights flips on rounding
    noise) — and decode from a prefill of the prompt's first S − SERVE_GEN
    tokens (kernels on) against the full prefill's logits at the positions
    it decodes; each as max |Δlogit| / max |logit|. Kernels off must
    launch nothing. A moe config also reports its routing flips between
    the kernels-on and -off runs (``_routing``)."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    moe = cfg.family == "moe"
    toks = inputs["tokens"]
    S, npch = toks.shape[1], _n_patches(cfg)
    runs, probes = {}, {}
    for on in (True, False):
        c = cfg.replace(use_pallas=on)
        _zero_counts()
        with _RouteProbe(moe) as probe:
            logits, cache = make_prefill_step(c, decode_budget=SERVE_GEN)(
                params, inputs)
            n_pre = probe.mark()
            serve = make_serve_step(c)
            steps = []
            for tok in fed:
                lg, cache = serve(params, cache, tok)
                steps.append(lg)
        if not on and any(_counts().values()):
            die(f"{cfg.name}: use_pallas=False launched a kernel: "
                f"{_counts()}")
        runs[on] = (logits, torch.cat(steps, 1))
        probes[on] = probe
        del cache, steps
    d_prefill = _rel_logit_diff(runs[True][0], runs[False][0])
    d_decode = _rel_logit_diff(runs[True][1], runs[False][1])
    full = runs[True][0]
    del runs
    routing = (_routing(f"{cfg.name}_{cfg.dtype}", probes[True],
                        probes[False], n_pre, cfg.n_layers) if moe else {})
    # the cache on the card: prefill S − SERVE_GEN tokens (after any
    # patches), then decode the rest teacher-forced; step t's logits are
    # position npch + t's
    on = cfg.replace(use_pallas=True)
    n0 = S - SERVE_GEN
    with _RouteProbe(moe) as tf_probe:
        _, cache = make_prefill_step(on, decode_budget=SERVE_GEN)(
            params, dict(inputs, tokens=toks[:, :n0]))
    if moe:
        routing.update(_tf_flips(probes[True], tf_probe, toks.shape[0], S,
                                 n0, cfg.n_layers))
    del probes, tf_probe
    cache_prefill = _cache_fields(cfg.name, cfg, cache)
    # an audio decoder's cross-attention cache: set by the prefill, only
    # read by decode
    cross = {k: (cache[k], cache[k].clone()) for k in ("cross_k", "cross_v")
             if k in cache}
    serve = make_serve_step(on)
    tf = []
    for t in range(n0, S):
        lg, cache = serve(params, cache, toks[:, t:t + 1])
        tf.append(lg)
    cache_decode = _cache_fields(cfg.name, cfg, cache)
    for key, (held, before) in cross.items():
        same = cache[key] is held and torch.equal(cache[key], before)
        cache_decode[f"{key}_unchanged_by_decode"] = same
        if not same:
            die(f"{cfg.name}: decode changed or replaced cache[{key!r}]")
    del cross
    d_cache = _rel_logit_diff(torch.cat(tf, 1), full[:, npch + n0:])
    return {"prefill_kernels_vs_plain": d_prefill,
            "decode_kernels_vs_plain": d_decode,
            "decode_vs_teacher_forced_prefill": d_cache,
            "max_abs_logit": float(full.float().abs().max()),
            "teacher_forced_from": npch + n0,
            "cache_after_prefill": cache_prefill,
            "cache_after_decode": cache_decode, **routing}


def _check_agreements(name, agree, limit):
    for key in ("prefill_kernels_vs_plain", "decode_kernels_vs_plain",
                "decode_vs_teacher_forced_prefill"):
        if not agree[key] <= limit:
            die(f"{name}: {key}: max |Δlogit| / max |logit| = "
                f"{agree[key]} > {limit}")


def phase_serve_path(name, arch, expect, *, batch=SERVE_BATCH,
                     prompt=SERVE_PROMPT, layers=0, fp32_layers=0):
    """``arch`` at full width in bf16 (its first ``layers`` layers when
    that is not 0), served through the port's entry points: prefill of
    ``batch`` prompts of ``prompt`` tokens (after a vlm's patches) and 32
    greedy decode steps; one prefill and its decode must launch each
    kernel exactly as ``expect`` says ({name: launches}, every other
    kernel never), every flash call with the config's sliding window;
    kernels off must agree, and decode must reproduce the teacher-forced
    prefill; with ``fp32_layers`` the same three agreements in fp32 at
    that depth (see FP32_LOGIT_TOL). Returns the launch counts."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import init_params, param_count

    cfg = get_config(arch).replace(use_pallas=True)
    full_layers = cfg.n_layers
    if layers:
        cfg = cfg.replace(n_layers=layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    inputs = _serve_inputs(cfg, batch, prompt)
    npch = _n_patches(cfg)
    prefill = make_prefill_step(cfg, decode_budget=SERVE_GEN)
    serve = make_serve_step(cfg)
    V = cfg.vocab

    def run_serve():
        """prefill, then SERVE_GEN greedy steps; returns the prefill
        logits, the tokens fed to decode, each step's logits, the two
        walls and the cache's slots after the prefill and the decode."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        tok = logits[:, -1:, :V].argmax(dim=-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        slots = [_cache_fields(name, cfg, cache)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fed, step_logits = [], []
        for _ in range(SERVE_GEN):
            fed.append(tok)
            lg, cache = serve(params, cache, tok)
            step_logits.append(lg)
            tok = lg[:, :, :V].argmax(dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        slots.append(_cache_fields(name, cfg, cache))
        return logits, fed, step_logits, prefill_s, decode_s, slots

    with _FlashWindows() as flash:            # warm-up: cuBLAS, allocator
        run_serve()
    windows = sorted(set(flash.calls))
    if any(w != cfg.sliding_window for _, w in flash.calls):
        die(f"{name}: flash_attention ran with (Sq, window) {windows}, "
            f"expected window {cfg.sliding_window}")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    logits_on, fed, steps_on, prefill_s, decode_s, slots = run_serve()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = {k: expect.get(k, 0) for k in launches}
    if launches != want:
        die(f"{name}: one prefill and its decode launched {launches}, "
            f"expected {want}")
    gen_tokens = torch.cat(fed, dim=1)
    finite = bool(torch.isfinite(logits_on).all()) and all(
        bool(torch.isfinite(x).all()) for x in steps_on)
    if logits_on.shape != (batch, npch + prompt, cfg.padded_vocab) \
            or not finite:
        die(f"{name}: prefill logits {tuple(logits_on.shape)}, finite "
            f"{finite}")
    ntok = batch * (npch + prompt)
    prefill_flops, prefill_mfu = _lm_flops(cfg, n_params, "prefill",
                                           npch + prompt, batch, prefill_s)
    decode_flops, decode_mfu = _lm_flops(cfg, n_params, "decode",
                                         npch + prompt, batch,
                                         decode_s / SERVE_GEN)
    audio = ({"enc_frames": cfg.enc_frames,
              "encoder_frames_per_s": batch * cfg.enc_frames / prefill_s,
              "decoder_tokens_per_s": ntok / prefill_s}
             if cfg.is_encdec else {})
    emit({"phase": name, "config": cfg.name, "dtype": cfg.dtype,
          **_config_fields(cfg), "layers_of": full_layers,
          "params": n_params, "init_s": init_s, "batch": batch,
          "prompt": prompt, "patches": npch, "decode_steps": SERVE_GEN,
          "launches": launches, "flash_sq_window": windows,
          "cache_after_prefill": slots[0], "cache_after_decode": slots[1],
          "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": ntok / prefill_s,
          "decode_ms_per_step": decode_s * 1e3 / SERVE_GEN,
          "decode_tokens_per_s": batch * SERVE_GEN / decode_s,
          "model_flops": {"prefill": prefill_flops,
                          "decode_step": decode_flops},
          "mfu": {"prefill": prefill_mfu, "decode": decode_mfu},
          "mfu_dtype": cfg.dtype, "card": RUN["card"],
          "peak_mem_gb": peak_gb, **audio,
          "generated_req0": gen_tokens[0, :8].tolist()})

    del logits_on, steps_on
    agree = _serve_agreements(cfg, params, inputs, fed)
    limit = BF16_LOGIT_TOL[cfg.family]
    emit({"phase": "serve_agreement", "path": name, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "limit": limit, **agree})
    _check_agreements(name, agree, limit)
    torch.cuda.empty_cache()
    held = {}

    def profiled_prefill():
        held["out"] = prefill(params, inputs)

    prefix = name.removesuffix("_path")
    _profile(profiled_prefill, prefill_s, f"{prefix}_prefill")
    logits, cache = held.pop("out")
    tok = logits[:, -1:, :V].argmax(dim=-1)
    del logits
    _profile(lambda: serve(params, cache, tok), decode_s / SERVE_GEN,
             f"{prefix}_decode")
    if fp32_layers:
        # fp32 weights from the same seed (at the same depth, the bf16
        # weights are these, rounded)
        del params, cache, held
        gc.collect()
        torch.cuda.empty_cache()
        f32 = cfg.replace(dtype="float32", n_layers=fp32_layers)
        params = init_params(f32, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        agree = _serve_agreements(f32, params, inputs, fed)
        emit({"phase": "serve_agreement", "path": name, "dtype": "float32",
              "n_layers": f32.n_layers, "limit": FP32_LOGIT_TOL, **agree})
        _check_agreements(f"{name} (fp32)", agree, FP32_LOGIT_TOL)
        for part in ("prefill", "decode", "teacher_forced_prefill"):
            worst = agree.get(f"{part}_first_layer_max_margin")
            if worst is not None and worst > FP32_FLIP_MARGIN:
                die(f"{name} (fp32): in the first layer where the two "
                    f"{part} runs route apart, a token changed its top-"
                    f"{f32.top_k} experts at a routing margin of {worst} "
                    f"> {FP32_FLIP_MARGIN}")
    return launches


# ------------------------------------------------------ LM training paths
# both paths: batch 8 x 512 tokens from synthetic_lm_batches (seed 1),
# random weights drawn on the card from seed 0, full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 3
# kernels on vs off after step 1 (the runs' losses are equal before the
# first update): |Δloss| / loss
TRAIN_LOSS_RTOL = 1e-2


def _train_flops(cfg, n_params, seq, wall_ms):
    """A train path's ``model_flops`` for one step of TRAIN_BATCH × ``seq``
    tokens and its ``mfu`` over the median step wall (``_lm_flops``)."""
    flops, mfu = _lm_flops(cfg, n_params, "train", seq, TRAIN_BATCH,
                           wall_ms / 1e3)
    return {"model_flops": flops, "mfu": mfu, "mfu_dtype": cfg.dtype,
            "card": RUN["card"]}


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


def _phase3_gate(fused, plain, g_local, g_server, w, cs):
    """Phase 3's kernels (``fused``: Eq. 4 with the clip scale ``cs``
    inside, rounded once) against the plain chain (``plain``: the clipped
    gradient rounded, then Eq. 4) over trees of bf16 leaves, within
    ``ref.plain_chain_bound``. Returns (all within that, elements more than one ulp of the
    result apart, share of elements that differ, the largest gap over its
    bound, Σ|fused − fp32 Eq. 4|, Σ|plain − fp32 Eq. 4|)."""
    from repro_torch.kernels.tpgf_fusion import ref as R
    from repro_torch.tree import tree_flatten_with_path
    ok, beyond, differ, n, worst, err_k, err_p = True, 0, 0, 0, 0.0, 0., 0.
    for (_, k), (_, p), (_, a), (_, b) in zip(
            tree_flatten_with_path(fused), tree_flatten_with_path(plain),
            tree_flatten_with_path(g_local),
            tree_flatten_with_path(g_server)):
        if not k.numel():
            continue
        kf, pf = k.float(), p.float()
        exact = R.eq4_fp32(a, b, w, cs)
        one = R.bf16_ulp(kf).maximum(R.bf16_ulp(pf))
        gap = (kf - pf).abs()
        bound = R.plain_chain_bound(k, p, a, w, cs)
        ok &= bool((gap <= bound).all())
        worst = max(worst, float((gap / bound).max()))
        beyond += int((gap > one).sum())
        differ += int((gap > 0).sum())
        n += k.numel()
        err_k += float((kf - exact).abs().sum())
        err_p += float((pf - exact).abs().sum())
    return ok, beyond, differ / n, worst, err_k, err_p


def _train_run(cfg, step_fn, opt, name, steps, seq=TRAIN_SEQ):
    """``steps`` steps of ``step_fn`` on batches of TRAIN_BATCH × ``seq``
    from seed-0 weights on the card, each timed after
    ``torch.cuda.synchronize()``; launch counts set to 0 just before the
    first step. Returns (params, opt_state, per-step records, launches,
    peak GB, the last batch)."""
    import torch
    from repro_torch.launch.train import device_batches, train
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    opt_state = opt.init(params)
    batches = list(device_batches(cfg, seq, TRAIN_BATCH, steps, "cuda"))
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
    ntok = TRAIN_BATCH * seq
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
    with the kernels on: Phase 3 runs ``sumsq`` and ``fuse`` on the bf16
    client gradients (4 launches each a step per client leaf) and no
    other kernel may launch (the scan records a gradient, so it takes
    ``ssd_chunked``). Gate on the kernels: the first microbatch's fused
    client gradient against the plain chain (``clip_by_global_l2``, then
    ``fuse_gradients``) on the same gradients within the plain chain's
    extra rounding (``_phase3_gate``), no farther in all from the fp32
    Eq. 4, and the same bits on a second call. Then the same steps
    with the kernels off and Phase 3 through the plain chain
    (``_plain_phase3``), launching nothing, from the same weights:
    step-1 losses bit for bit, later ones within TRAIN_LOSS_RTOL; a
    profiled step."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import supernet as SN
    from repro_torch.core import tpgf as T
    from repro_torch.kernels.tpgf_fusion import ops as O
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
    calls, inner = [], T.clip_and_fuse

    def watched(*args, **kwargs):
        calls.append(args)
        return inner(*args, **kwargs)

    T.clip_and_fuse = watched
    _zero_counts()
    try:
        out = T.tpgf_grads_split(cfg, cfg, *SN.split_params(cfg, params, d),
                                 mb0, d)
        torch.cuda.synchronize()
    finally:
        T.clip_and_fuse = inner
    gate_launches = _counts()
    gl, gs, w, tau = calls[0]
    fused = out.g_client
    losses = [float(out.loss_client), float(out.loss_server),
              float(out.w_client)]
    del out, calls
    again = O.fuse_tree(gl, gs, w.float(), tau=tau)
    clipped, norm = T.clip_by_global_l2(gl, tau)
    cs = torch.clamp(tau / (norm + 1e-12), max=1.0)
    plain = T.fuse_gradients(clipped, gs, w)
    del clipped
    n_leaves = len(tree_leaves(fused))
    finite = all(bool(torch.isfinite(x).all()) for x in
                 tree_leaves(fused)) and all(map(math.isfinite, losses))
    if not finite:
        die("lm_train_path gate: the fused client gradient or a loss is "
            "not finite")
    ok, beyond, share, worst, err_k, err_p = _phase3_gate(
        fused, plain, gl, gs, w, cs)
    det_worst, det_share = _ulp_gate(fused, again)
    emit({"phase": "lm_train_gate", "config": cfg.name,
          "split_depth": d, "client_leaves": n_leaves,
          "launches_kernels_on": gate_launches, "losses": losses,
          "clip_scale": float(cs), "within_rounding": ok,
          "gap_over_bound_max": worst,
          "elements_beyond_one_ulp": beyond,
          "fused_client_grad_share_differing": share,
          "abs_err_vs_fp32_kernels": err_k, "abs_err_vs_fp32_plain": err_p,
          "repeat_max_bf16_ulps": det_worst,
          "repeat_share_differing": det_share})
    want = {k: n_leaves if k in PHASE3_KERNELS else 0
            for k in gate_launches}
    if gate_launches != want:
        die(f"lm_train_path gate: launches {gate_launches}, expected "
            f"{want}")
    if not ok or err_k > err_p or det_worst:
        die(f"lm_train_path gate: the kernels' fused client gradient is "
            f"{worst} of the plain chain's rounding from it (limit 1), "
            f"{err_k} from the fp32 Eq. 4 against the plain chain's "
            f"{err_p}, {det_worst} bf16 ulps from its own second call")
    del gl, gs, w, fused, again, plain, params
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for on in (True, False):
        c = cfg.replace(use_pallas=on)
        step_fn, opt = make_train_step(c)
        name = f"lm_train_path/{'kernels' if on else 'plain'}"
        with contextlib.nullcontext() if on else _plain_phase3():
            params, opt_state, recs, launches, peak_gb, last = _train_run(
                c, step_fn, opt, name, TRAIN_STEPS)
        runs[on] = recs
        if not on and any(launches.values()):
            die(f"{name}: kernels off launched {launches}")
        if on:
            _check_train_launches(name, c, params, launches, TRAIN_STEPS)
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
                  **_train_flops(cfg, n_params, TRAIN_SEQ, wall_ms),
                  "peak_mem_gb": peak_gb})
            _profile(lambda: step_fn(params, opt_state, last),
                     wall_ms / 1e3, "lm_train")
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
    return {k: TRAIN_STEPS * mb * n_leaves for k in PHASE3_KERNELS}


def phase_dense_train_path(arch):
    """Llama-3.2-3B at full width and depth trained through
    ``launch/train.py``'s config and loop (one microbatch, bf16, remat,
    ``adamw(1e-3)``) with the kernels off, as the reference can only
    train it: finite losses, ``sumsq`` and ``fuse`` once per client leaf
    and no other launch, step wall, tokens/s, peak memory, a profiled
    step."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import param_count
    from repro_torch.optim import adamw
    cfg = train_config(arch, reduced=False)
    step_fn, opt = make_train_step(cfg, adamw(1e-3))
    params, opt_state, recs, launches, peak_gb, last = _train_run(
        cfg, step_fn, opt, "dense_train_path", TRAIN_STEPS)
    _check_train_launches("dense_train_path", cfg, params, launches,
                          TRAIN_STEPS)
    walls = [r["wall_ms"] for r in recs[1:]] or [recs[0]["wall_ms"]]
    wall_ms = statistics.median(walls)
    n_params = param_count(params)
    emit({"phase": "dense_train_path", "config": cfg.name,
          **_config_fields(cfg), "dtype": cfg.dtype,
          "params": n_params, "remat": cfg.remat,
          "microbatches": cfg.microbatches,
          "split_depth": cfg.resolved_split_depth, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches": launches,
          "step_wall_ms": wall_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
          **_train_flops(cfg, n_params, TRAIN_SEQ, wall_ms),
          "peak_mem_gb": peak_gb})
    _profile(lambda: step_fn(params, opt_state, last), wall_ms / 1e3,
             "dense_train")
    return launches


def phase_moe_train_path(arch, layers):
    """Mixtral-8x7B at full width, its first ``layers`` layers (split
    depth 1), trained by ``make_train_step`` with its config (bf16, remat,
    4 microbatches, AdamW with fp32 moments) with the kernels off (the
    family has attention, and flash has no backward): 3 steps of 8 × 512,
    finite losses, Phase 3's ``sumsq`` and ``fuse`` once per client leaf
    and microbatch and no other launch, then the first microbatch's TPGF
    gradients once more for the prefix's router aux (the step reports 0.0
    with more than one microbatch, as the reference does), finite and
    positive. Step wall, tokens/s, peak memory, a profiled step."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import tpgf as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import param_count
    cfg = get_config(arch).replace(n_layers=layers)
    step_fn, opt = make_train_step(cfg)
    params, opt_state, recs, launches, peak_gb, last = _train_run(
        cfg, step_fn, opt, "moe_train_path", TRAIN_STEPS)
    _check_train_launches("moe_train_path", cfg, params, launches,
                          TRAIN_STEPS)
    mb0 = {k: v[:TRAIN_BATCH // cfg.microbatches] for k, v in last.items()}
    out = T.tpgf_grads(cfg, params, mb0, cfg.resolved_split_depth)
    aux = float(out.aux)
    del out
    if not (math.isfinite(aux) and aux > 0):
        die(f"moe_train_path: the prefix's router aux is {aux}")
    walls = [r["wall_ms"] for r in recs[1:]] or [recs[0]["wall_ms"]]
    wall_ms = statistics.median(walls)
    n_params = param_count(params)
    emit({"phase": "moe_train_path", "config": cfg.name,
          **_config_fields(cfg), "layers_of": get_config(arch).n_layers,
          "dtype": cfg.dtype, "params": n_params,
          "remat": cfg.remat, "microbatches": cfg.microbatches,
          "split_depth": cfg.resolved_split_depth,
          "moment_dtype": cfg.adam_moment_dtype, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches": launches,
          "prefix_router_aux_microbatch0": aux,
          "step_wall_ms": wall_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
          **_train_flops(cfg, n_params, TRAIN_SEQ, wall_ms),
          "peak_mem_gb": peak_gb})
    _profile(lambda: step_fn(params, opt_state, last), wall_ms / 1e3,
             "moe_train")
    return launches


def phase_audio_train_path(arch):
    """Whisper-small whole at its config (bf16, remat, one microbatch,
    AdamW with the config's moment dtype) through ``launch/train.py``'s
    loop with the kernels off, 3 steps of 8 × 448 decoder tokens over
    zero frames (the launcher's): finite losses, Phase 3's launches
    alone; and
    ``make_train_step`` must refuse ``use_pallas=True`` (the decoder's
    self-attention is causal, and flash has no backward). Step wall,
    tokens/s, peak memory, a profiled step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import param_count
    cfg = get_config(arch)
    try:
        make_train_step(cfg.replace(use_pallas=True))
        refusal = None
    except NotImplementedError as exc:
        refusal = str(exc)
    if refusal is None:
        die("audio_train_path: make_train_step accepted use_pallas=True")
    step_fn, opt = make_train_step(cfg)
    params, opt_state, recs, launches, peak_gb, last = _train_run(
        cfg, step_fn, opt, "audio_train_path", TRAIN_STEPS,
        seq=AUDIO_TRAIN_SEQ)
    _check_train_launches("audio_train_path", cfg, params, launches,
                          TRAIN_STEPS)
    walls = [r["wall_ms"] for r in recs[1:]] or [recs[0]["wall_ms"]]
    wall_ms = statistics.median(walls)
    n_params = param_count(params)
    emit({"phase": "audio_train_path", "config": cfg.name,
          **_config_fields(cfg), "dtype": cfg.dtype,
          "params": n_params, "remat": cfg.remat,
          "microbatches": cfg.microbatches,
          "split_depth": cfg.resolved_split_depth,
          "moment_dtype": cfg.adam_moment_dtype, "batch": TRAIN_BATCH,
          "seq": AUDIO_TRAIN_SEQ, "steps": TRAIN_STEPS,
          "launches": launches, "use_pallas_refused": refusal,
          "step_wall_ms": wall_ms,
          "tokens_per_s": TRAIN_BATCH * AUDIO_TRAIN_SEQ / (wall_ms / 1e3),
          **_train_flops(cfg, n_params, AUDIO_TRAIN_SEQ, wall_ms),
          "peak_mem_gb": peak_gb})
    _profile(lambda: step_fn(params, opt_state, last), wall_ms / 1e3,
             "audio_train")
    return launches


def _is_port_kernel(name: str) -> bool:
    """A profiler row of one of the port's CUDA kernels (``csrc/``)."""
    return any(f"(anonymous namespace)::{k}" in name for k in PORT_KERNELS)


def _profile(step, unprofiled_wall_s: float, path: str, host: bool = True):
    """One more call of ``step`` (a round, a prefill) under
    torch.profiler: device time by kernel, and the device's idle share
    against the wall time of the same step unprofiled. Returns the device
    busy ms. ``host=False`` traces the card alone (no host op rows to
    process: a step of many small ops profiles in a fraction of the
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host else [ProfilerActivity.CUDA]) as prof:
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
    return busy_ms


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
def timed_phase(name, fn, *args, **kw):
    """``fn(*args, **kw)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "phase_time", "path": name,
          "seconds": time.perf_counter() - t0})
    return out


def _largest_client_leaf(cfg):
    """The shape of the largest leaf of ``cfg``'s client view at its
    split depth (on the meta device: shapes only)."""
    from repro_torch.core.supernet import split_params
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves
    client = split_params(cfg, init_params(cfg, None, device="meta"),
                          cfg.resolved_split_depth)[0]
    return tuple(max(tree_leaves(client), key=lambda x: x.numel()).shape)


def kernel_shapes():
    """The shapes at which each kernel is checked, timed and bounded:
    the largest call of the path that carries it (computed on the host:
    configs, the main path's fleet, meta tensors). ``fuse`` and ``sumsq``
    at the deepest client's MLP leaf, ``fuse`` in bf16 at Mamba2's largest
    client leaf, ``aggregate`` over the 8 clients' MLP stack, ``tier_sum``
    at the server rows of the shallowest mixed-width cohort; the serving
    kernels at each serve path's prefill, (B, S, H, K, head_dim) and
    Mixtral's window, (B, S, heads, head_dim, state) for ``ssd_scan``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.allocation import allocate_widths
    from repro_torch.federated.simulator import make_fleet
    cfg = get_config("vit16_cifar")
    fleet = make_fleet(cfg, 8, seed=0)
    d_max = int(fleet.depths.max())
    widths = allocate_widths([p.mem_gb for p in fleet.profiles], LADDER)
    d_mix = min(int(d) for d in set(fleet.depths.tolist())
                if len(set(widths[fleet.depths == d])) > 1)
    lm = get_config(SERVE_ARCH)
    ssm, hybrid = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    moe, vlm = get_config(MOE_ARCH), get_config(VLM_ARCH)
    audio = get_config(AUDIO_ARCH)

    def attention(c, batch, prompt):
        return (batch, prompt, c.n_heads, c.n_kv_heads, c.resolved_head_dim)

    def scan(c):
        return (SERVE_BATCH, SERVE_PROMPT, c.ssm_n_heads, c.ssm_head_dim,
                c.ssm_state)

    return {"fuse": (d_max, cfg.d_model, cfg.d_ff),
            "fuse_bf16": _largest_client_leaf(ssm),
            "aggregate": (8, cfg.n_layers, cfg.d_model * cfg.d_ff),
            # one rank's share of the 8 clients on the fleet mesh path
            "aggregate_numerator": (8 // FLEET_RANKS, cfg.n_layers,
                                    cfg.d_model * cfg.d_ff),
            "tier_sum": (cfg.n_layers - d_mix, cfg.d_model, cfg.d_ff),
            "sumsq": (d_max, cfg.d_model, cfg.d_ff),
            "flash": attention(lm, SERVE_BATCH, SERVE_PROMPT),
            "flash_hymba": attention(hybrid, SERVE_BATCH, SERVE_PROMPT),
            "flash_mixtral": attention(moe, MOE_SERVE_BATCH,
                                       MOE_SERVE_PROMPT)
            + (moe.sliding_window,),
            "flash_internvl2": attention(vlm, SERVE_BATCH,
                                         vlm.n_patches + VLM_SERVE_TEXT),
            "flash_whisper": attention(audio, AUDIO_SERVE_BATCH,
                                       AUDIO_SERVE_PROMPT),
            "ssd_scan": scan(ssm), "ssd_scan_hymba": scan(hybrid)}


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        die(f"{SRC / 'repro_torch'} not found: run this script from the "
            "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    try:
        import torch  # noqa: F401
    except ImportError:
        die("torch is not installed")
    if "--fleet-rank" in sys.argv[1:]:
        i = sys.argv.index("--fleet-rank")
        _fleet_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                    sys.argv[i + 3], sys.argv[i + 4])
        return
    if "--fleet-nccl" in sys.argv[1:]:
        phase_environment()
        phase_build()
        launches = timed_phase("fleet_nccl_path", phase_fleet_nccl)
        emit({"fleet_nccl_path_launches": launches})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return
    if "--lm-rank" in sys.argv[1:]:
        i = sys.argv.index("--lm-rank")
        _lm_mesh_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                      sys.argv[i + 3])
        return
    if "--lm-mesh" in sys.argv[1:]:
        phase_environment()
        phase_build()
        launches = timed_phase("lm_mesh_cards", phase_lm_mesh_cards)
        emit({"lm_mesh_cards_launches": launches})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return
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
    cfg = get_config("vit16_cifar")
    lm = get_config(SERVE_ARCH)
    ssm, hybrid = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    shapes = kernel_shapes()
    d_max = shapes["fuse"][0]
    rows = [phase_fuse(shapes["fuse"], shapes["fuse_bf16"]),
            phase_aggregate(*shapes["aggregate"]),
            phase_aggregate_numerator(*shapes["aggregate_numerator"]),
            phase_tier_sum(shapes["tier_sum"]),
            phase_sumsq(shapes["sumsq"]),
            phase_flash(*(shapes[k] for k in (
                "flash", "flash_hymba", "flash_mixtral", "flash_internvl2",
                "flash_whisper")), logs["flash_attention"]),
            phase_ssd_scan(shapes["ssd_scan"], shapes["ssd_scan_hymba"],
                           logs["ssd_scan"])]
    torch.cuda.empty_cache()
    phase_ncu()
    launches = {}
    main_launches, eng = phase_path("main_path",
                                    ("sumsq", "fuse", "aggregate"),
                                    count_flops=True)
    launches["main_path"] = main_launches
    launches["clip_path"] = phase_clip_path(cfg, eng.state.params, d_max)
    del eng
    torch.cuda.empty_cache()
    launches["fleet_mesh_path"] = timed_phase("fleet_mesh_path",
                                              phase_fleet_mesh_path)
    timed_phase("sanitize_path", phase_sanitize_path)
    launches["width_path"] = phase_path(
        "width_path", ("sumsq", "fuse", "aggregate", "tier_sum"),
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
        "ssm_serve_path", SSM_ARCH, {"ssd_scan": ssm.n_layers},
        fp32_layers=ssm.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    launches["hybrid_serve_path"] = phase_serve_path(
        "hybrid_serve_path", HYBRID_ARCH,
        {"flash_attention": hybrid.n_layers, "ssd_scan": hybrid.n_layers},
        fp32_layers=hybrid.n_layers)
    gc.collect()                      # the Hymba weights go first
    torch.cuda.empty_cache()
    launches["moe_serve_path"] = timed_phase(
        "moe_serve_path", phase_serve_path, "moe_serve_path", MOE_ARCH,
        {"flash_attention": MOE_SERVE_LAYERS}, batch=MOE_SERVE_BATCH,
        prompt=MOE_SERVE_PROMPT, layers=MOE_SERVE_LAYERS,
        fp32_layers=MOE_FP32_LAYERS)
    gc.collect()                      # the Mixtral weights go first
    torch.cuda.empty_cache()
    launches["vlm_serve_path"] = timed_phase(
        "vlm_serve_path", phase_serve_path, "vlm_serve_path", VLM_ARCH,
        {"flash_attention": vlm.n_layers}, prompt=VLM_SERVE_TEXT)
    gc.collect()
    torch.cuda.empty_cache()
    # the decoder runs flash once a layer; the encoder and decode none
    launches["audio_serve_path"] = timed_phase(
        "audio_serve_path", phase_serve_path, "audio_serve_path",
        AUDIO_ARCH, {"flash_attention": audio.n_layers},
        batch=AUDIO_SERVE_BATCH, prompt=AUDIO_SERVE_PROMPT,
        fp32_layers=audio.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = {"moe_train_path": timed_phase(
        "moe_train_path", phase_moe_train_path, MOE_ARCH, MOE_TRAIN_LAYERS)}
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["audio_train_path"] = timed_phase(
        "audio_train_path", phase_audio_train_path, AUDIO_ARCH)
    gc.collect()                      # the serving weights go first
    torch.cuda.empty_cache()
    train_launches["lm_train_path"] = phase_lm_train_path(SSM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["dense_train_path"] = phase_dense_train_path(SERVE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    launches["lm_mesh_path"] = timed_phase("lm_mesh_path",
                                           phase_lm_mesh_path)
    # each kernel's launches come from the path that carries it
    carried_by = {"fuse": "main_path", "aggregate": "main_path",
                  "aggregate_numerator": "fleet_mesh_path",
                  "tier_sum": "width_path", "sumsq": "main_path",
                  "flash_attention": "serve_path",
                  "ssd_scan": "ssm_serve_path"}
    also = dict(scenario, clip_path=launches["clip_path"],
                moe_serve_path=launches["moe_serve_path"],
                vlm_serve_path=launches["vlm_serve_path"],
                audio_serve_path=launches["audio_serve_path"],
                moe_train_path=train_launches["moe_train_path"],
                audio_train_path=train_launches["audio_train_path"],
                lm_mesh_path=launches["lm_mesh_path"])
    for row in rows:
        row["path"] = carried_by[row["name"]]
        row["launches"] = launches[row["path"]][row["name"]]
        row["also_on"] = {path: n[row["name"]] for path, n in also.items()
                          if n[row["name"]]}
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "also_on")
    # the hybrid path runs both serving kernels, and the baselines run
    # aggregate; their launches stand here
    emit({"hybrid_serve_path_launches": launches["hybrid_serve_path"]})
    emit({"moe_serve_path_launches": launches["moe_serve_path"]})
    emit({"vlm_serve_path_launches": launches["vlm_serve_path"]})
    emit({"audio_serve_path_launches": launches["audio_serve_path"]})
    emit({"moe_train_path_launches": train_launches["moe_train_path"]})
    emit({"baseline_path_launches": baseline})
    emit({"scenario_path_launches": scenario})
    emit({"train_path_launches": train_launches})
    emit({"lm_mesh_path_launches": launches["lm_mesh_path"]})
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
