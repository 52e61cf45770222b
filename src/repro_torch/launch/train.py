"""End-to-end SuperSFL training launcher: the production TPGF train step
(``launch.steps.make_train_step``) on synthetic Markov-chain LM data
(``data.synthetic.synthetic_lm_batches``), on one device or, with
``--mesh``, sharded over the ranks of a ``("data", "model")`` mesh.

Run on the card (full width, random weights from a seed):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \
        --steps 4 --batch 8 --seq 512 --log-every 1

or on the CPU with the reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \
        --reduced --device cpu --steps 60 --batch 8 --seq 128

As in the JAX package's launcher, the config trains with one microbatch,
the reduced config in fp32 and the full one in its own dtype, with
``adamw(--lr)``; each logged step prints one JSON record (``step``,
``elapsed_s``, ``loss_client``, ``loss_server``, ``w_client``, ``aux``),
and ``--ckpt PATH`` writes the final params as ``PATH.npz`` +
``PATH.json`` in the reference's checkpoint format (bf16 leaves
included).

``--mesh`` alone builds the production mesh (16, 16), as the
reference's launcher does, and raises below 256 ranks; ``--mesh DxM``
builds ``make_test_mesh((D, M))`` over the world. Start the ranks with
``torchrun`` (one a card; NCCL on the cards, gloo with ``--device
cpu``); the process group comes from torchrun's environment:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mamba2_2_7b --mesh 4x1 --steps 4 --batch 8 --seq 512

Each rank draws the same seeded init and keeps its shards
(``init_params(..., mesh=)``); the moments take the parameters'
placements, the batch is placed by ``batch_pspecs``. Only rank 0 prints
and writes ``--ckpt`` (the shards gathered first, the same format).
``--mesh 1x1`` runs in one process, bit for bit the meshless run.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Iterable, List

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import base
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw


def train_config(arch: str, reduced: bool):
    """The launcher's config: one microbatch; fp32 when reduced."""
    cfg = base.get_reduced(arch) if reduced else base.get_config(arch)
    return cfg.replace(microbatches=1,
                       dtype="float32" if reduced else cfg.dtype)


def device_batches(cfg, seq: int, batch: int, steps: int, device,
                   seed: int = 1) -> Iterable[dict]:
    """The launcher's data on ``device``: ``synthetic_lm_batches`` with the
    reference's seed; a vlm batch gets zero ``patches`` [batch,
    n_patches, d_model] and an audio batch zero ``frames`` [batch,
    enc_frames, d_model], in the config's dtype, as the reference's
    launcher gives them."""
    extra = M.side_input_shapes(cfg, batch)
    for b in synthetic_lm_batches(cfg.vocab, seq, batch, steps, seed=seed):
        out = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        for k, shape in extra.items():
            out[k] = torch.zeros(shape, dtype=M.torch_dtype(cfg),
                                 device=device)
        yield out


def train(step_fn, params, opt_state, batches: Iterable[dict], *,
          log_every: int = 10, on_step: Callable = None,
          out: Callable = print):
    """The launcher's loop: ``step_fn`` over ``batches``; steps 1 and every
    ``log_every``-th are recorded (host floats, so the loop syncs there)
    and printed through ``out``. ``on_step(i, metrics)`` runs after each
    step. Returns (params, opt_state, the records)."""
    t0 = time.time()
    history: List[dict] = []
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(i, metrics)
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rec = {"step": i + 1, "elapsed_s": round(time.time() - t0, 1),
                   **{k: round(v, 4) for k, v in m.items()}}
            history.append(rec)
            out(json.dumps(rec))
    return params, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", nargs="?", const="production", default=None,
                    help="shard over a mesh: alone the production mesh "
                         "(256 ranks), or DxM for make_test_mesh((D, M))")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    mesh, own_group = (None, False) if args.mesh is None else \
        launch_mesh(args.mesh, device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = mesh is None or mesh.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = train_config(args.arch, args.reduced)
    step_fn, opt = make_train_step(cfg, adamw(args.lr))
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device, mesh=mesh)
    opt_state = opt.init(params)
    say(f"arch={cfg.name} params={M.param_count(params) / 1e6:.1f}M "
        f"split_depth={cfg.resolved_split_depth}/{cfg.split_stack_len} "
        f"device={device}" + ("" if mesh is None else f" mesh={mesh}"))
    batches = device_batches(cfg, args.seq, args.batch, args.steps, device)
    if mesh is not None:
        batches = (SH.distribute_tree(b, SH.batch_pspecs(cfg, None, b, mesh),
                                      mesh) for b in batches)
    params, opt_state, history = train(step_fn, params, opt_state, batches,
                                       log_every=args.log_every, out=say)
    if args.ckpt:
        whole = SH.gather_tree(params)
        if rank0:
            save_checkpoint(args.ckpt, whole, step=args.steps,
                            meta={"arch": cfg.name})
        say(f"saved checkpoint to {args.ckpt}.npz")
    l0, l1 = history[0]["loss_server"], history[-1]["loss_server"]
    say(f"loss_server {l0:.3f} -> {l1:.3f} "
        f"({'LEARNING' if l1 < l0 else 'NOT LEARNING'})")
    if own_group:
        import torch.distributed as dist
        dist.destroy_process_group()
    return history


def launch_mesh(arg: str, device):
    """``--mesh``'s mesh and whether this call started the process group:
    from torchrun's environment when it set one (NCCL on the cards, gloo
    on the CPU), else none (a one-rank mesh makes its own)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    own = not dist.is_initialized()
    if own and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device.type == "cuda" and dist.is_initialized() else device)
    if arg == "production":
        mesh = make_production_mesh(device=dev)
    else:
        mesh = make_test_mesh(tuple(int(n) for n in arg.lower().split("x")),
                              device=dev)
    return mesh, own


if __name__ == "__main__":
    main()
