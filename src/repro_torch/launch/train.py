"""End-to-end SuperSFL training launcher: the production TPGF train step
(``launch.steps.make_train_step``) on synthetic Markov-chain LM data
(``data.synthetic.synthetic_lm_batches``), on one device.

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
included). ``--mesh`` (the reference's production mesh) is not ported.
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
    ap.add_argument("--mesh", action="store_true",
                    help="the reference's production mesh (not ported)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: multi-device training is ROADMAP queue 1, \"Fleet "
            "sharding and multi-device\"")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")

    cfg = train_config(args.arch, args.reduced)
    step_fn, opt = make_train_step(cfg, adamw(args.lr))
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device)
    opt_state = opt.init(params)
    print(f"arch={cfg.name} params={M.param_count(params) / 1e6:.1f}M "
          f"split_depth={cfg.resolved_split_depth}/{cfg.split_stack_len} "
          f"device={device}")
    params, opt_state, history = train(
        step_fn, params, opt_state,
        device_batches(cfg, args.seq, args.batch, args.steps, device),
        log_every=args.log_every)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps,
                        meta={"arch": cfg.name})
        print(f"saved checkpoint to {args.ckpt}.npz")
    l0, l1 = history[0]["loss_server"], history[-1]["loss_server"]
    print(f"loss_server {l0:.3f} -> {l1:.3f} "
          f"({'LEARNING' if l1 < l0 else 'NOT LEARNING'})")
    return history


if __name__ == "__main__":
    main()
