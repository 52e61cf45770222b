"""The stacked-layer model: the ``vit`` family ((patch embed) -> the layer
stack -> (mean pool, head)) and the causal LM families ((token embed) ->
the layer stack -> (final norm, untied unembed)): ``dense`` (rope'd causal
attention and an MLP per layer), ``moe`` (the same attention, then a
top-k mixture of experts in place of the MLP, whose router loss each
layer adds to ``aux``), ``vlm`` (the dense layers over a prefix of
projected image patches, ``batch["patches"] @ vision_proj``, before the
token embeddings; the losses skip the patch positions), ``ssm`` (one
Mamba-2 mixer per layer, attention-free), ``hybrid`` (attention and a
Mamba-2 mixer side by side on one normed input, then an MLP), ``ssm_moe``
(Granite-4.0-H: each layer's mixer is a Mamba-2 mixer or NoPE attention
as ``layer_kinds`` orders them, then a mixture of experts held in part
and a shared expert, both branches scaled by ``residual_multiplier``;
tokens embedded times ``embedding_multiplier``, both heads' logits
divided by ``logits_scaling``) and ``audio``, the Whisper
encoder-decoder: audio frames
(``batch["frames"] @ frame_proj`` plus a sinusoid) through the encoder
stack ``enc_layers`` (non-causal attention, no rope), ``enc_norm``, then
the decoder stack ``dec_layers`` over ``embed[tokens]·√d_model +
dec_pos`` (causal self-attention without rope, cross-attention on the
encoder's output, a gelu MLP), ``dec_norm`` and the head tied to
``embed``. The encoder is the split stack: a client holds
``frame_proj`` and the first ``d`` encoder layers, and its local head
predicts every label position from the frames' mean (a unigram head).

The stacked tree (leading ``L`` axis) is the paper's weight-sharing
super-network: a client subnetwork of depth ``d`` is the row slice
``[:d]`` of every stacked leaf. The JAX package also has a masked
runtime-depth scan over all ``L`` rows, which exists only to keep XLA's
compile key small; eager PyTorch has no compile key, so the port always
slices the stack at ``d`` (the JAX package pins its static and runtime
forms bit-exact, and ``tests/test_torch_model.py`` holds this slice
against its runtime form).

Every family but ``ssm_moe`` serves (the LM families through
``models/decode.py``), and every family trains through the SuperSFL
surfaces below (``ssm_moe`` at full width and without a mesh); the LM
families' losses are next-token cross-entropies over the unpadded
vocabulary, weighted by
``batch["valid"]`` where the batch has one. With ``cfg.remat`` each layer
of a forward that records a gradient is checkpointed (its activations are
recomputed in the backward), the reference's ``jax.checkpoint`` of the
scan body.
On a ``("data", "model")`` mesh (parameters placed by ``init_params(...,
mesh=)`` or ``launch.sharding.distribute_tree``) the same surfaces run
sharded: each function below hands a DTensor input to its counterpart in
``models/sharded.py``, which runs this module's own code on each rank's
local shards. The reference's ``_constrain_batch`` pins the batch axis
inside its scans; the port's activations keep their rows over the data
axes from the embedding on, so it has no separate step.

Public surface (the JAX module's names):
  init_params(cfg, gen, device)
  side_input_shapes(cfg, batch)           the inputs beside ``tokens``
  layer_role / embed_tokens / embed_inputs / run_stack
  encode / decode_tokens / sinusoid       the audio encoder and decoder
  prefix_apply(cfg, params, batch, d)     -> (z, aux)   smashed data
  client_apply(cfg, client_params, batch) -> (z, aux)
  local_logits / local_loss               the client's fault-tolerant head
  suffix_apply / server_apply             -> (logits, aux) server branch
  server_split_loss / server_loss
  full_loss                               the FedAvg family's loss
  predict / local_predict                 global and client-side inference
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LAYER_KINDS, ModelConfig
from repro_torch.core import supernet as SN
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import (tree_flatten_with_path, tree_get, tree_leaves,
                              tree_map, tree_rebuild, tree_unflatten)

Params = Dict[str, Any]

# rows of the audio decoder's learned position table (the reference's)
DEC_POS_ROWS = 32768


FAMILIES = ("vit", "dense", "moe", "vlm", "ssm", "hybrid", "audio",
            "ssm_moe")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family={cfg.family!r}: the port runs the families of the "
            f"JAX package's model zoo and ssm_moe, {', '.join(FAMILIES)}")


def side_input_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """The inputs an LM family takes beside ``tokens`` (the reference's
    ``make_dummy_batch`` draws them): a vlm prompt's ``patches`` [batch,
    n_patches, d_model], an audio request's ``frames`` [batch,
    enc_frames, d_model]; none for the others."""
    if cfg.family == "vlm":
        return {"patches": (batch, cfg.n_patches, cfg.d_model)}
    if cfg.is_encdec:
        return {"frames": (batch, cfg.enc_frames, cfg.d_model)}
    return {}


def layer_role(cfg: ModelConfig) -> str:
    return {"dense": "dense", "moe": "moe", "ssm": "ssm", "hybrid": "hybrid",
            "vlm": "dense", "audio": "enc", "vit": "enc",
            "ssm_moe": "ssm_moe"}[cfg.family]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[cfg.dtype]


# ----------------------------------------------------------------- stack init

def _layer_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                  role: str) -> Params:
    """One layer's parameter tree for ``role``: "enc" (vit, the audio
    encoder) and "dense" (also vlm) have the same leaves; "dec" (the
    audio decoder) adds ``cross_norm_*`` and the cross-attention
    ``cross`` after ``attn``; "moe" has ``moe`` in place of ``mlp``;
    "ssm" a norm and the mixer; "hybrid" both, plus a per-channel scale
    for each branch."""
    dm = cfg.d_model
    p: Params = {}
    if role in ("enc", "dec", "dense", "moe", "hybrid", "ssm"):
        p.update({f"attn_norm_{k}": v
                  for k, v in L.norm_params(cfg, dm, dtype).items()})
    if role in ("enc", "dec", "dense", "moe", "hybrid"):
        p["attn"] = L.attn_params(cfg, gen, dtype)
        if role == "dec":
            p.update({f"cross_norm_{k}": v
                      for k, v in L.norm_params(cfg, dm, dtype).items()})
            p["cross"] = L.attn_params(cfg, gen, dtype)
        p.update({f"mlp_norm_{k}": v
                  for k, v in L.norm_params(cfg, dm, dtype).items()})
        if role == "moe":
            p["moe"] = MOE.moe_params(cfg, gen, dtype)
        else:
            p["mlp"] = L.mlp_params(cfg, gen, dtype)
    if role in ("ssm", "hybrid"):
        p["ssm"] = SSM.ssm_params(cfg, gen, dtype)
    if role == "hybrid":
        p["branch_scale_attn"] = L.ones((dm,), dtype)
        p["branch_scale_ssm"] = L.ones((dm,), dtype)
    return p


def _stack(cfg: ModelConfig, gen: torch.Generator, n: int, dtype,
           role: str, keep=None) -> Params:
    """``n`` layers of ``role`` drawn in turn, each copied into its row of
    a stacked tree allocated once: the stack never exists twice
    (Mixtral-8x7B's 16 layers are 47 GB in bf16). ``keep(path, x)`` (a
    mesh's init) cuts each drawn row leaf to the part this rank keeps."""
    def rows(layer):
        return {path: (x if keep is None else keep(path, x))
                for path, x in tree_flatten_with_path(layer)}

    layer = _layer_params(cfg, gen, dtype, role)
    kept = rows(layer)
    out = {path: x.new_empty((n,) + tuple(x.shape))
           for path, x in kept.items()}
    for i in range(n):
        if i:
            layer = _layer_params(cfg, gen, dtype, role)
            kept = rows(layer)
        for path, x in kept.items():
            out[path][i].copy_(x)
        del layer, kept
    return tree_unflatten(list(out), list(out.values()))


def _ssm_moe_stack(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """The ssm_moe family's stack, drawn layer by layer in published
    order: the norms before the mixer and before the experts, and the
    ``moe``, with a row for every layer; each kind's mixers (``mamba``:
    ``ssm.granite_params``, ``attention``: ``layers.attn_params``) with a
    row for every layer of that kind. Each stacked leaf is allocated
    once, as ``_stack``'s are."""
    kinds = cfg.layer_kinds
    if len(kinds) != cfg.n_layers or set(kinds) - set(LAYER_KINDS):
        raise ValueError(f"layer_kinds must give one of {LAYER_KINDS} for "
                         f"each of the {cfg.n_layers} layers: {kinds}")
    out: Dict[Tuple, torch.Tensor] = {}
    seen = dict.fromkeys(LAYER_KINDS, 0)
    for i, kind in enumerate(kinds):
        mixer = (SSM.granite_params(cfg, gen, dtype) if kind == "mamba"
                 else L.attn_params(cfg, gen, dtype))
        layer = {"mixer_norm_scale": L.zeros((cfg.d_model,), dtype),
                 kind: mixer,
                 "ffn_norm_scale": L.zeros((cfg.d_model,), dtype),
                 "moe": MOE.moe_params(cfg, gen, dtype)}
        for path, x in tree_flatten_with_path(layer):
            row, n = ((seen[kind], kinds.count(kind)) if path[0] == kind
                      else (i, len(kinds)))
            if path not in out:
                out[path] = x.new_empty((n,) + tuple(x.shape))
            out[path][row].copy_(x)
        seen[kind] += 1
        del layer, mixer
    return tree_unflatten(list(out), list(out.values()))


def _local_head(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dtype = torch_dtype(cfg)
    return {"local_head": L.dense_init(gen, cfg.d_model, cfg.n_classes,
                                       dtype),
            "local_head_bias": L.zeros((cfg.n_classes,), dtype)}


def init_local_head(cfg: ModelConfig, gen: torch.Generator,
                    device=None) -> Params:
    """The fault-tolerant client head phi_i alone, on ``device`` (None:
    the card, see ``repro_torch.device``)."""
    device = resolve_device(device)
    return {k: v.to(device) for k, v in _local_head(cfg, gen).items()}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None, *, mesh=None) -> Params:
    """The reference's shapes, dtypes and distributions, drawn from a
    ``torch.Generator`` on its own device (``jax.random`` bits cannot be
    reproduced in torch; tests carry the reference's weights across with
    ``repro_torch.bridge``), then moved to ``device`` (None: the card,
    see ``repro_torch.device``). A CUDA generator draws a full-size model
    on the card; ``gen=None`` with ``device="meta"`` gives shapes and
    dtypes only.

    The LM families' global head is always untied (``unembed``), as in
    the reference: SuperSFL puts the embedding on the client and the head
    on the server. The audio decoder's head stays tied to ``embed``
    (both live on the server, the split stack being the encoder);
    ``dec_pos`` has the reference's 32,768 rows.

    With ``mesh`` (an LM mesh of ``launch.mesh``) every rank draws the
    same stream, leaf by leaf and layer row by layer row, and keeps only
    its shard of each as ``launch.sharding.param_pspecs`` places it: the
    parameters are DTensors with the values of the meshless init of the
    same seed, and a rank's peak is its shards plus one layer row."""
    check_family(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    dm = cfg.d_model
    p: Params = {}
    keep = {}
    if mesh is not None:
        shapes = init_params(cfg, None, device="meta")
        specs = SH.param_pspecs(cfg, shapes, mesh)

        def keep_in(stack):
            def cut(path, x):
                pls = SH.placements(tree_get(specs[stack], path)[1:], mesh)
                return SH.local_slice(x, mesh, pls).clone()
            return cut
        keep = {k: keep_in(k) for k in ("layers", "enc_layers",
                                        "dec_layers")}
    if cfg.family == "vit":
        pdim = cfg.patch_size * cfg.patch_size * 3
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        p["patch_embed"] = L.dense_init(gen, pdim, dm, dtype)
        p["patch_bias"] = L.zeros((dm,), dtype)
        p["pos_embed"] = L.normal(gen, (n_patches, dm), dtype)
        p["layers"] = _stack(cfg, gen, cfg.n_layers, dtype, "enc",
                             keep.get("layers"))
        p["head"] = L.dense_init(gen, dm, cfg.n_classes, dtype)
        p["head_bias"] = L.zeros((cfg.n_classes,), dtype)
        p.update(_local_head(cfg, gen))
    elif cfg.is_encdec:
        p["frame_proj"] = L.dense_init(gen, dm, dm, dtype)
        p["embed"] = L.normal(gen, (cfg.padded_vocab, dm), dtype)
        p["dec_pos"] = L.normal(gen, (DEC_POS_ROWS, dm), dtype)
        p["enc_layers"] = _stack(cfg, gen, cfg.n_enc_layers, dtype, "enc",
                                 keep.get("enc_layers"))
        p["dec_layers"] = _stack(cfg, gen, cfg.n_layers, dtype, "dec",
                                 keep.get("dec_layers"))
        p["enc_norm"] = L.norm_params(cfg, dm, dtype)
        p["dec_norm"] = L.norm_params(cfg, dm, dtype)
        p["local_head"] = L.dense_init(gen, dm, cfg.padded_vocab, dtype)
    else:
        p["embed"] = L.normal(gen, (cfg.padded_vocab, dm), dtype)
        if cfg.family == "vlm":
            p["vision_proj"] = L.dense_init(gen, dm, dm, dtype)
        p["layers"] = (_ssm_moe_stack(cfg, gen, dtype)
                       if cfg.family == "ssm_moe" else
                       _stack(cfg, gen, cfg.n_layers, dtype, layer_role(cfg),
                              keep.get("layers")))
        p["final_norm"] = L.norm_params(cfg, dm, dtype)
        p["unembed"] = L.dense_init(gen, dm, cfg.padded_vocab, dtype)
        p["local_head"] = L.dense_init(gen, dm, cfg.padded_vocab, dtype)
    if mesh is None:
        return tree_map(lambda x: x.to(device), p)
    out = {}
    for path, x in tree_flatten_with_path(p):
        spec = tree_get(specs, path)
        x = x.to(device)
        if path[0] in keep:      # the stacks: already this rank's shard
            pls = SH.placements(spec, mesh)
            shape = tuple(tree_get(shapes, path).shape)
            out[path] = SH.as_dtensor(x, mesh, pls, shape)
        else:
            out[path] = SH.place(x, spec, mesh)
    return tree_rebuild(p, out)


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ------------------------------------------------------------- layer bodies

def _attn_block(cfg: ModelConfig, p, h, *, positions, causal, window,
                use_rope: bool = False):
    """Returns (attn_out_projected, (k, v) post-rope for caching), with
    the reference's dispatch: the flash kernel for causal attention over
    more than one query under ``use_pallas``, else the blockwise loop from
    ``ATTN_BLOCKWISE_THRESHOLD`` on, else plain attention."""
    x = L.apply_norm(cfg, h, p, "attn_norm")
    q, k, v = L.project_qkv(cfg, p["attn"], x, x)
    if use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    if cfg.use_pallas and q.shape[1] > 1 and causal:
        out = FA.flash_attention(q, k, v, causal=causal, window=window)
    elif q.shape[1] >= L.ATTN_BLOCKWISE_THRESHOLD:
        out = L.blockwise_attention(q, k, v, causal=causal, window=window)
    else:
        # an all-True mask (non-causal, no window) is the identity: skip it
        mask = (L.make_attn_mask(positions, positions, causal=causal,
                                 window=window)
                if causal or window else None)
        out = L.attention(q, k, v, mask=mask)
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["attn"]["wo"], (k, v)


def _ssm_block(cfg: ModelConfig, p, h, emit: bool):
    """The mixer on the normed input: (out, {"ssm_h", "ssm_conv"} when
    ``emit``, else {})."""
    x = L.apply_norm(cfg, h, p, "attn_norm")
    if emit:
        s, hf, conv = SSM.ssm_apply(cfg, p["ssm"], x, return_state=True)
        return s, {"ssm_h": hf, "ssm_conv": conv}
    return SSM.ssm_apply(cfg, p["ssm"], x), {}


def _cross_block(cfg: ModelConfig, p, h, enc_out):
    """The audio decoder's cross-attention from the normed ``h`` to the
    encoder's output, unmasked: (out projected, (k, v) over the frames
    for the cache)."""
    x = L.apply_norm(cfg, h, p, "cross_norm")
    q, k, v = L.project_qkv(cfg, p["cross"], x, enc_out)
    out = L.attention(q, k, v)
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["cross"]["wo"], (k, v)


def ffn(cfg: ModelConfig, role: str, p, h):
    """The layer's feed-forward half on the residual ``h``: (h + the MLP,
    or the moe layer's mixture of experts, of the normed input; the moe
    layer's router loss, else None)."""
    x = L.apply_norm(cfg, h, p, "mlp_norm")
    if role == "moe":
        y, aux = MOE.moe_apply(cfg, p["moe"], x)
        return h + y, aux
    return h + L.mlp_apply(cfg, p["mlp"], x), None


def _layer(cfg: ModelConfig, role: str, p, h, *, positions, causal, window,
           use_rope: bool = False, emit: bool = False, enc_out=None):
    """One layer of ``role``; returns (h, aux, the layer's cache
    entries): aux is the moe layer's router loss (fp32), None for the
    other roles. A "dec" layer cross-attends to ``enc_out`` after its
    self-attention and adds "cross_k" and "cross_v" to its entries."""
    if role == "ssm":
        s, ys = _ssm_block(cfg, p, h, emit)
        return h + s, None, ys
    out, (k, v) = _attn_block(cfg, p, h, positions=positions, causal=causal,
                              window=window, use_rope=use_rope)
    ys = {"k": k, "v": v}
    if role == "hybrid":
        s, st = _ssm_block(cfg, p, h, emit)
        ys.update(st)
        h = h + p["branch_scale_attn"] * out + p["branch_scale_ssm"] * s
    else:
        h = h + out
    if role == "dec":
        out, (ck, cv) = _cross_block(cfg, p, h, enc_out)
        h = h + out
        ys.update(cross_k=ck, cross_v=cv)
    return (*ffn(cfg, role, p, h), ys)


def _nope_attention(cfg: ModelConfig, p, x, positions):
    """The ssm_moe family's causal GQA attention on the normed ``x``: no
    position embedding, scores scaled by ``attention_multiplier``; the
    blockwise loop from ``ATTN_BLOCKWISE_THRESHOLD`` on, else plain."""
    q, k, v = L.project_qkv(cfg, p, x, x)
    scale = cfg.attention_multiplier or None
    if q.shape[1] >= L.ATTN_BLOCKWISE_THRESHOLD:
        out = L.blockwise_attention(q, k, v, causal=True, scale=scale)
    else:
        mask = L.make_attn_mask(positions, positions, causal=True)
        out = L.attention(q, k, v, mask=mask, scale=scale)
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def _ssm_moe_layer(cfg: ModelConfig, kind: str, p, mixer, h, positions):
    """One ssm_moe layer: h + r·mixer(norm(h)), then h + r·(the held
    experts' part + the shared expert)(norm(h)), r the
    ``residual_multiplier``; returns (h, the router's balance term)."""
    eps, r = cfg.rms_norm_eps, cfg.residual_multiplier
    x = L.rmsnorm(h, p["mixer_norm_scale"], eps)
    m = (SSM.granite_mix(cfg, mixer, x) if kind == "mamba"
         else _nope_attention(cfg, mixer, x, positions))
    h = h + m * r
    y, aux = MOE.moe_apply(cfg, p["moe"], L.rmsnorm(h, p["ffn_norm_scale"],
                                                    eps))
    return h + y * r, aux


def _run_ssm_moe(cfg: ModelConfig, stack: Params, h, *, positions,
                 first: int):
    """``run_stack`` for the ssm_moe family: row i of ``stack`` is layer
    ``first + i``, of kind ``cfg.layer_kinds[first + i]``, and takes the
    next row of that kind's mixer stack."""
    n = stack_len(stack)
    kinds = cfg.layer_kinds[first:first + n]
    mixers = {k: iter(_rows(stack[k], kinds.count(k)))
              for k in LAYER_KINDS if k in stack}
    rows = _rows({k: v for k, v in stack.items() if k not in LAYER_KINDS},
                 n)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for kind, row in zip(kinds, rows):
        layer = functools.partial(_ssm_moe_layer, cfg, kind,
                                  positions=positions)
        if remat:
            h, a = checkpoint(layer, row, next(mixers[kind]), h,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = layer(row, next(mixers[kind]), h)
        aux = aux + a
    return h, aux


def _row(tree, i: int):
    return {k: (_row(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _rows(tree, n: int):
    """The ``n`` per-layer trees of a stacked tree, from one ``unbind``
    per leaf: its backward stacks the rows' gradients once, where a
    backward through ``n`` separate ``x[i]`` would fill and add ``n``
    stack-sized gradients."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    per = {k: _rows(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def stack_len(stack: Params) -> int:
    """The layers of a stack (an ssm_moe stack's kind stacks hold fewer
    rows each)."""
    leaves = tree_leaves({k: v for k, v in stack.items()
                          if k not in LAYER_KINDS})
    return int(leaves[0].shape[0]) if leaves else 0


def run_stack(cfg: ModelConfig, stack: Params, h, *, positions,
              causal: bool = False, window: int = 0, emit: bool = False,
              role: str = None, enc_out=None, first: int = 0):
    """Apply every row of ``stack`` to ``h`` in order (the caller slices
    the depth window). ``role`` defaults to the config's ``layer_role``;
    the audio decoder passes "dec" and the encoder's output ``enc_out``.
    ``first`` is the layer of the stack's first row (a server view's is
    the split depth); only the ssm_moe family, whose layers differ by
    kind, reads it, and it has no ``emit``.
    Returns (h, aux), and with ``emit`` (h, aux, ys): ys stacks each
    layer's cache entries along a leading L axis — the post-rope "k" and
    "v" [L, B, S, K, hd] of an attention layer, a decoder layer's
    "cross_k" and "cross_v" [L, B, T_enc, K, hd], the final SSM state
    "ssm_h" [L, B, nh, hd, st] (fp32) and the conv tail "ssm_conv"
    [L, B, k-1, d_inner] of a mixer. aux is the sum of the moe layers'
    router losses in fp32, as the reference's scan carries it, and 0.0
    for the other families.

    With ``cfg.remat``, while grad mode is on and without ``emit``, each
    layer runs under ``torch.utils.checkpoint`` (non-reentrant): only its
    inputs are kept (``enc_out`` among them, so a decoder layer's
    backward reaches the encoder), and every backward pass through it
    recomputes its forward, so TPGF's two backward passes through one
    prefix graph each recompute it."""
    if SH.is_dtensor(h):
        from repro_torch.models import sharded
        return sharded.run_stack(cfg, stack, h, causal=causal, window=window,
                                 emit=emit, role=role, enc_out=enc_out)
    role = role or layer_role(cfg)
    if role == "ssm_moe":
        if emit:
            raise NotImplementedError("family='ssm_moe' has no decode "
                                      "cache: serving is not ported")
        return _run_ssm_moe(cfg, stack, h, positions=positions, first=first)
    use_rope = role in ("dense", "moe", "hybrid")
    remat = cfg.remat and not emit and torch.is_grad_enabled()

    def layer(p, x, e=None):
        return _layer(cfg, role, p, x, positions=positions, causal=causal,
                      window=window, use_rope=use_rope, enc_out=e)[:2]

    # a decoder layer's checkpoint takes enc_out as an input of its own
    extra = () if enc_out is None else (enc_out,)
    per = []
    aux = 0.0
    for row in _rows(stack, stack_len(stack)):
        if remat:
            h, a = checkpoint(layer, row, h, *extra, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a, ys = _layer(cfg, role, row, h, positions=positions,
                              causal=causal, window=window,
                              use_rope=use_rope, emit=emit, enc_out=enc_out)
            if emit:
                per.append(ys)
        if a is not None:
            aux = aux + a
    if emit:
        return h, aux, {k: torch.stack([ys[k] for ys in per])
                        for k in (per[0] if per else {})}
    return h, aux


# ---------------------------------------------------------------- embeddings

def embed_tokens(cfg: ModelConfig, params: Params, tokens):
    """``embed[tokens]·√d_model`` (ssm_moe: times
    ``embedding_multiplier``): the LM families' token embedding."""
    emb = params["embed"]
    # the reference's weak-typed scalar is rounded to the embedding's
    # dtype before the product, as this 0-d tensor is
    mult = (cfg.embedding_multiplier if cfg.family == "ssm_moe"
            else math.sqrt(cfg.d_model))
    scale = torch.tensor(mult, dtype=emb.dtype, device=emb.device)
    return emb[tokens.long()] * scale


def sinusoid(S: int, dm: int, dtype, device=None):
    """The audio encoder's fixed position signal [S, dm]: sin | cos of
    pos / 10000^(2i/dm), computed in fp32 and cast to ``dtype``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, dm, 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, dim / dm)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def embed_inputs(cfg: ModelConfig, params: Params, batch) -> Tuple[Any, Any]:
    """Returns (h [B,S,dm], positions [B,S]). vit: the reference's
    patchify order (rows of patches, then columns, then pixels and
    channels); audio: ``frames`` [B, T, dm] (cast to the weights' dtype)
    ``@ frame_proj`` plus ``sinusoid``, the encoder's input; the other
    LM families: ``embed_tokens``, and for vlm a batch with ``patches``
    [B, n_patches, dm] puts ``patches @ vision_proj`` before the
    tokens. Sharded parameters give (h, None): a sharded layer makes its
    own positions."""
    check_family(cfg)
    if SH.mesh_of(params) is not None:
        from repro_torch.models import sharded
        return sharded.embed_inputs(cfg, params, batch)
    if cfg.is_encdec:
        fp = params["frame_proj"]
        h = batch["frames"].to(fp.dtype) @ fp
        h = h + sinusoid(h.shape[1], cfg.d_model, h.dtype, h.device)[None]
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
        return h, pos
    if cfg.family != "vit":
        h = embed_tokens(cfg, params, batch["tokens"])
        if cfg.family == "vlm" and "patches" in batch:
            pe = batch["patches"].to(h.dtype) @ params["vision_proj"]
            h = torch.cat([pe, h], dim=1)
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
        return h, pos
    img = batch["images"]
    B, Hh, Ww, C = img.shape
    ps = cfg.patch_size
    patches = img.reshape(B, Hh // ps, ps, Ww // ps, ps, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
        B, (Hh // ps) * (Ww // ps), ps * ps * C)
    h = patches.to(params["patch_embed"].dtype) @ params["patch_embed"]
    h = h + params["patch_bias"] + params["pos_embed"][None]
    pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
    return h, pos


def _head_logits(cfg: ModelConfig, params: Params, h):
    if SH.is_dtensor(h):
        from repro_torch.models import sharded
        keys = (("head", "head_bias") if cfg.family == "vit" else
                ("embed",) if cfg.is_encdec else ("unembed",))
        return sharded.rows_call(cfg, _head_logits,
                                 {k: params[k] for k in keys}, h)
    if cfg.family == "vit":
        pooled = h.mean(dim=1)
        return pooled @ params["head"] + params["head_bias"]
    if cfg.is_encdec:
        return h @ params["embed"].T      # the decoder's head stays tied
    if cfg.family == "ssm_moe":
        return (h @ params["unembed"]) / cfg.logits_scaling
    return h @ params["unembed"]


def _norm(cfg: ModelConfig, p, h):
    """A stand-alone norm stored as {"scale"(, "bias")}."""
    if SH.is_dtensor(h):
        from repro_torch.models import sharded
        return sharded.rows_call(cfg, _norm, p, h)
    return L.apply_norm(cfg, h, {f"attn_norm_{k}": v for k, v in p.items()},
                        "attn_norm")


def final_norm(cfg: ModelConfig, params: Params, h):
    """The LM families' last norm before the head (the audio decoder's
    ``dec_norm``)."""
    if cfg.family == "ssm_moe":
        return L.rmsnorm(h, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return _norm(cfg, params["dec_norm" if cfg.is_encdec else
                             "final_norm"], h)


def encode(cfg: ModelConfig, params: Params, h):
    """The audio encoder's rows in ``params["enc_layers"]`` over ``h``,
    then ``enc_norm``: (enc_out, aux)."""
    pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
    h, aux = run_stack(cfg, params["enc_layers"], h, positions=pos,
                       role="enc")
    return _norm(cfg, params["enc_norm"], h), aux


def decode_tokens(cfg: ModelConfig, params: Params, tokens, enc_out,
                  emit: bool = False):
    """The audio decoder over ``tokens`` [B, S]: ``embed_tokens`` plus
    ``dec_pos[:S]``, then every row of ``dec_layers`` (causal
    self-attention, cross-attention on ``enc_out``), before
    ``dec_norm``; run_stack's (h, aux) or, with ``emit``, (h, aux, ys)."""
    S = tokens.shape[1]
    if SH.is_dtensor(enc_out):
        from repro_torch.models import sharded
        h = sharded.embed_decoder(cfg, params, tokens)
    else:
        h = embed_tokens(cfg, params, tokens) + params["dec_pos"][:S][None]
    pos = torch.arange(S, device=h.device).expand(tokens.shape)
    return run_stack(cfg, params["dec_layers"], h, positions=pos,
                     causal=True, emit=emit, role="dec", enc_out=enc_out)


def _causal(cfg: ModelConfig) -> bool:
    return layer_role(cfg) in ("dense", "moe", "hybrid", "ssm_moe")


# --------------------------------------------------------- SuperSFL surfaces


def client_apply(cfg: ModelConfig, client_params: Params, batch):
    """Forward an already-split client view (stack rows ``[:d]``) ->
    smashed z."""
    h, pos = embed_inputs(cfg, client_params, batch)
    return run_stack(cfg, client_params[cfg.split_stack_name], h,
                     positions=pos, causal=_causal(cfg),
                     window=cfg.sliding_window)


def prefix_apply(cfg: ModelConfig, params: Params, batch, d: int):
    """Client-side forward through the first ``d`` layers of the full
    tree -> smashed data."""
    view = dict(params)
    name = cfg.split_stack_name
    view[name] = SN.depth_window(cfg, params[name], 0, d)
    return client_apply(cfg, view, batch)


def local_logits(cfg: ModelConfig, params: Params, z):
    """Fault-tolerant lightweight client head on smashed data: vit pools
    the tokens, audio the frames (one unigram distribution a sequence),
    the other LM families predict every position."""
    check_family(cfg)
    if SH.is_dtensor(z):
        from repro_torch.models import sharded
        return sharded.rows_call(cfg, local_logits, {
            k: params[k] for k in ("local_head", "local_head_bias")
            if k in params}, z)
    if cfg.family == "vit":
        pooled = z.mean(dim=1)
        return pooled @ params["local_head"] + params["local_head_bias"]
    if cfg.is_encdec:
        return z.mean(dim=1) @ params["local_head"]
    if cfg.family == "ssm_moe":
        return (z @ params["local_head"]) / cfg.logits_scaling
    return z @ params["local_head"]


def _label_fields(cfg: ModelConfig, batch):
    if cfg.family == "vit":
        return batch["label"], None
    return batch["labels"], batch.get("valid")


def _xent(cfg: ModelConfig, logits, batch):
    """The loss of ``logits`` against the batch's labels; vlm skips the
    ``n_patches`` image positions."""
    if SH.is_dtensor(logits):
        from repro_torch.models import sharded
        return sharded.xent(cfg, logits, batch)
    labels, valid = _label_fields(cfg, batch)
    if cfg.family == "vit":
        return L.softmax_xent(logits, labels)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    return L.softmax_xent(logits, labels, valid=valid, vocab=cfg.vocab)


def local_loss(cfg: ModelConfig, params: Params, z, batch):
    logits = local_logits(cfg, params, z)
    if SH.is_dtensor(logits):
        from repro_torch.models import sharded
        return sharded.xent(cfg, logits, batch, unigram=cfg.is_encdec)
    if cfg.is_encdec:
        # the unigram proxy: the pooled logits predict every label position
        logits = logits[:, None].expand(batch["labels"].shape
                                        + logits.shape[-1:])
    return _xent(cfg, logits, batch)


def server_apply(cfg: ModelConfig, server_params: Params, z, batch):
    """The server branch on an already-split view whose stack holds only
    the suffix rows ``[d:]``; the LM families end with ``final_norm``
    and ``unembed``. Audio: the encoder's suffix rows, ``enc_norm``, then
    the whole decoder over ``batch["tokens"]`` (``decode_tokens``),
    ``dec_norm`` and the tied head."""
    check_family(cfg)
    if cfg.is_encdec:
        enc_out, aux = encode(cfg, server_params, z)
        h, aux2 = decode_tokens(cfg, server_params, batch["tokens"], enc_out)
        return (_head_logits(cfg, server_params,
                             final_norm(cfg, server_params, h)), aux + aux2)
    pos = torch.arange(z.shape[1], device=z.device).expand(z.shape[:2])
    stack = server_params["layers"]
    h, aux = run_stack(cfg, stack, z, positions=pos, causal=_causal(cfg),
                       window=cfg.sliding_window,
                       first=cfg.n_layers - stack_len(stack))
    if cfg.family != "vit":
        h = final_norm(cfg, server_params, h)
    return _head_logits(cfg, server_params, h), aux


def suffix_apply(cfg: ModelConfig, params: Params, z, batch, d: int):
    """Server-side forward from smashed data to logits: rows ``[d:]``."""
    sp = dict(params)
    name = cfg.split_stack_name
    sp[name] = SN.depth_window(cfg, params[name], d)
    return server_apply(cfg, sp, z, batch)


def _server_xent(cfg: ModelConfig, logits, aux, batch):
    return _xent(cfg, logits, batch) + cfg.router_aux_coef * aux


def server_split_loss(cfg: ModelConfig, server_params: Params, z, batch):
    """The server branch's loss over an already-split server view."""
    logits, aux = server_apply(cfg, server_params, z, batch)
    return _server_xent(cfg, logits, aux, batch)


def server_loss(cfg: ModelConfig, params: Params, z, batch, d: int):
    """The server branch's loss over the full tree: stack rows ``[d:]``."""
    logits, aux = suffix_apply(cfg, params, z, batch, d)
    return _server_xent(cfg, logits, aux, batch)


def full_loss(cfg: ModelConfig, params: Params, batch):
    """Plain end-to-end loss (the FedAvg family): the prefix to
    ``cfg.resolved_split_depth``, then the server loss from there."""
    d = cfg.resolved_split_depth
    z, aux = prefix_apply(cfg, params, batch, d)
    return server_loss(cfg, params, z, batch, d) + cfg.router_aux_coef * aux


def predict(cfg: ModelConfig, params: Params, batch):
    """Global-model logits: every stack row, then the server head."""
    Lfull = cfg.split_stack_len
    z, _ = prefix_apply(cfg, params, batch, Lfull)
    logits, _ = suffix_apply(cfg, params, z, batch, Lfull)
    return logits


def local_predict(cfg: ModelConfig, params: Params, batch, d: int):
    """Client-side inference: depth-``d`` prefix + the phi head in
    ``params`` (callers overlay a client's phi_i on the global tree)."""
    z, _ = prefix_apply(cfg, params, batch, d)
    return local_logits(cfg, params, z)
