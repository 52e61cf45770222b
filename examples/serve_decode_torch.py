"""Serving example for the PyTorch/CUDA port: batched prefill + greedy
autoregressive decode with the KV/SSM cache.

The port's counterpart of ``examples/serve_decode.py`` (whose default is
Mixtral-8x7B, as this one's is): one prefill over a batch of prompts
(from ``synthetic_lm_batches``; a vlm prompt also carries ``n_patches``
seeded N(0, 1) image patches before its tokens, an audio prompt
``enc_frames`` seeded N(0, 1) frames for the encoder, as the reference's
``make_dummy_batch`` draws them, and its tokens go to the decoder) with
room for ``--gen`` tokens, then token-by-token greedy decode over the
first ``vocab`` logits. On a card, prefill runs the hand-written kernels
in every layer (their plain versions on the CPU): flash attention for
the dense, moe, vlm and hybrid families (windowed for Mixtral's
4,096-token sliding window) and the audio decoder, the SSD scan for the
ssm and hybrid ones; decode attends over the cache with plain attention
(an audio decoder layer also over its cross-attention cache, set once
by the prefill) and steps the SSM recurrence in plain PyTorch.

Run on the card (full width, random weights from a seed):

    PYTHONPATH=src python examples/serve_decode_torch.py
    PYTHONPATH=src python examples/serve_decode_torch.py internvl2_2b
    PYTHONPATH=src python examples/serve_decode_torch.py llama3_2_3b
    PYTHONPATH=src python examples/serve_decode_torch.py mamba2_2_7b
    PYTHONPATH=src python examples/serve_decode_torch.py whisper_small \
        --prompt 224

Mixtral-8x7B's 32 layers are 93.7 GB in bf16, more than one 80 GB card
holds, so at full size it serves its first ``--layers`` layers (default
16, 47.2 GB) and prints the cut; ``--layers N`` cuts any config.

or on the CPU with the reduced config (the kernels' plain versions):

    PYTHONPATH=src python examples/serve_decode_torch.py llama3_2_3b \\
        --reduced --device cpu --prompt 24 --gen 16
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm_batches  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import model as M  # noqa: E402

BATCH = 4


# full-size configs that do not fit one 80 GB card whole: the layers
# served unless --layers says otherwise
DEFAULT_LAYERS = {"mixtral_8x7b": 16}


def serve(cfg, params, batch, gen_len: int):
    """Prefill ``batch`` (``tokens`` [B, S], and ``patches`` for vlm,
    ``frames`` for audio; tensors on the params' device) with room for
    ``gen_len`` tokens, then greedy-decode ``gen_len`` tokens. Returns
    (generated [B, gen_len] numpy, cache, seconds of prefill, seconds of
    decode)."""
    prefill = make_prefill_step(cfg, decode_budget=gen_len)
    step = make_serve_step(cfg)
    dev = batch["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = logits[:, -1:, :cfg.vocab].argmax(dim=-1)
    sync()
    t1 = time.perf_counter()
    outs = [tok]
    for _ in range(gen_len - 1):
        logits, cache = step(params, cache, tok)
        tok = logits[:, :, :cfg.vocab].argmax(dim=-1)
        outs.append(tok)
    sync()
    t2 = time.perf_counter()
    gen = torch.cat(outs, dim=1).cpu().numpy()
    return gen, cache, t1 - t0, t2 - t1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="mixtral_8x7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() form")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt", type=int, default=2048,
                    help="text tokens a prompt (a vlm prompt adds its "
                         "n_patches image patches)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers (default: all; 16 for "
                         "full-size mixtral_8x7b)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (with "
                           "--reduced) to run on the CPU")
    cfg = (base.get_reduced if args.reduced else base.get_config)(args.arch)
    layers = args.layers or (None if args.reduced else
                             DEFAULT_LAYERS.get(base.canonical_id(args.arch)))
    if layers and layers != cfg.n_layers:
        print(f"cut: {layers} of {cfg.n_layers} layers")
        cfg = cfg.replace(n_layers=layers)
    cfg = cfg.replace(use_pallas=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device=args.device)
    init_s = time.perf_counter() - t0
    data = next(synthetic_lm_batches(cfg.vocab, args.prompt, BATCH, 1,
                                     seed=1))
    batch = {"tokens": torch.as_tensor(data["tokens"].astype(np.int64),
                                       device=args.device)}
    extra = M.side_input_shapes(cfg, BATCH)
    for k, shape in extra.items():
        x = np.random.default_rng(2).standard_normal(shape)
        batch[k] = torch.as_tensor(x.astype(np.float32),
                                   device=args.device).to(M.torch_dtype(cfg))
    out, cache, pre_s, dec_s = serve(cfg, params, batch, args.gen)
    window = f"  window={cache['k'].shape[2]}" if "k" in cache else ""
    shown = "".join(f"  {k}={shape[1]}" for k, shape in extra.items())
    print(f"arch={cfg.name}  device={args.device}  batch={BATCH}  "
          f"prompt={args.prompt}{shown}  generated={out.shape[1]} "
          f"tokens{window}")
    print(f"init {init_s:.2f} s  prefill {pre_s * 1e3:.1f} ms  decode "
          f"{dec_s * 1e3 / max(args.gen - 1, 1):.2f} ms/token")
    for b in range(2):
        print(f"  req{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
