"""Production step functions of the assembled super-network.

``make_train_step`` is the paper's technique at LM scale: embed -> client
prefix -> {local head loss; server suffix + head loss} -> two backward
passes through one prefix graph -> clip + TPGF fusion (Eqs. 3-4) -> the
optimizer, with the batch split into ``cfg.microbatches`` microbatches
whose gradients accumulate in fp32. Its phases are ``repro_torch.trace``
spans: ``train.step`` around the whole, ``train.microbatch`` around each
``tpgf_grads``, ``train.accumulate`` around the zeros and each add, and
around the final cast, and ``optim.apply`` around ``apply_in_place``.

``make_prefill_step`` / ``make_serve_step`` are the teacher-forced
cache-building forward and the single-token decode. Both run without
autograd: serving needs no graph, and the serving kernels have no
backward.

Every step takes sharded trees too: parameters, moments and caches of
DTensors placed by ``launch.sharding``'s LM rules run the sharded path of
``models/sharded.py``, and a plain batch is placed by ``batch_pspecs``
first.

``batch_specs`` / ``params_specs`` / ``cache_specs`` / ``token_specs`` /
``input_specs`` are the dry-run's abstract inputs: tensors on the
``meta`` device, shapes and dtypes with no allocation.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import tpgf as T
from repro_torch.launch.sharding import is_dtensor
from repro_torch.models import decode as D
from repro_torch.models import model as M
from repro_torch.models.model import layer_role
from repro_torch.optim import adamw
from repro_torch.trace import span
from repro_torch.tree import (tree_flatten_with_path, tree_get, tree_map,
                              tree_structure)


def _microbatches(batch, mb: int):
    """``batch`` cut into ``mb`` equal slices along its leading axis. A
    batch placed over the data axes is gathered first: a microbatch's
    rows lie on several ranks, and the sharded step places each
    microbatch's rows over the data axes again."""
    out = [dict() for _ in range(mb)]
    for k, v in batch.items():
        if is_dtensor(v):
            v = v.full_tensor()
        if v.shape[0] % mb:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of microbatches={mb}")
        for i, part in enumerate(v.reshape((mb, v.shape[0] // mb)
                                           + tuple(v.shape[1:]))):
            out[i][k] = part
    return out


def apply_in_place(opt, grads, opt_state, params):
    """``opt.update`` then ``apply_updates``, one leaf at a time, each new
    value written into the tensor it replaces: the same arithmetic as the
    whole-tree call, with no second copy of the moments or the
    parameters alive at once (at Llama-3.2-3B's full width that copy
    alone is 40 GB). ``opt_state`` must follow the optimizer state-shape
    contract (``optim.map_moments``): its moment entries are updated in
    place and its bookkeeping entries (AdamW's ``t``) replaced once."""
    pdef = tree_structure(params)
    stateful = isinstance(opt_state, dict)
    moments = ([k for k, v in opt_state.items()
                if tree_structure(v) == pdef] if stateful else [])
    new_book = {}
    for path, p in tree_flatten_with_path(params):
        sub = ({k: ({"x": tree_get(v, path)} if k in moments else v)
                for k, v in opt_state.items()} if stateful else opt_state)
        upd, new = opt.update({"x": tree_get(grads, path)}, sub, {"x": p})
        p.copy_(p + upd["x"].to(p.dtype))
        if stateful:
            for k in moments:
                tree_get(opt_state[k], path).copy_(new[k]["x"])
            new_book = {k: v for k, v in new.items() if k not in moments}
        del upd, new, sub
    if stateful:
        opt_state.update(new_book)
    return params, opt_state


def make_train_step(cfg: ModelConfig, opt=None):
    """-> (train_step, opt). ``train_step(params, opt_state, batch)``
    returns ``(params, opt_state, metrics)``, having updated ``params``
    and ``opt_state`` in place (see ``apply_in_place``), with metrics
    ``loss_client``, ``loss_server``, ``w_client`` (means over the
    microbatches) and ``aux`` as fp32 device scalars; ``aux`` is the
    client prefix's MoE router loss with one microbatch and 0.0 with
    more, as the reference reports it. The default
    optimizer is ``adamw(3e-4, weight_decay=0.1)`` with the config's
    ``adam_moment_dtype``. ``batch`` holds ``tokens`` and ``labels``
    [B, S] (and optionally ``valid``), B a multiple of
    ``cfg.microbatches``; a vlm batch also holds ``patches``
    [B, n_patches, d_model], an audio batch ``frames`` [B, T_enc,
    d_model].

    A family with causal attention (the audio decoder's too) trains only
    with ``use_pallas=False``: the flash kernel has no backward (nor has
    the reference's, whose step fails there too). The ssm family trains
    with the kernels on: its scan takes the plain ``ssd_chunked`` under
    autograd and Eq. 4 the ``fuse`` kernel."""
    if cfg.use_pallas and (layer_role(cfg) in ("dense", "moe", "hybrid",
                                               "ssm_moe") or cfg.is_encdec):
        raise NotImplementedError(
            f"train step, family={cfg.family!r} with use_pallas=True: the "
            "flash_attention kernel has no backward (nor has the JAX "
            "package's); train this family with use_pallas=False")
    opt = opt or adamw(3e-4, weight_decay=0.1,
                       moment_dtype=cfg.adam_moment_dtype)
    d = cfg.resolved_split_depth
    mb = max(cfg.microbatches, 1)

    def compute_grads(params, batch):
        if mb == 1:
            with span("train.microbatch"):
                out = T.tpgf_grads(cfg, params, batch, d)
            return out.grads, {"loss_client": out.loss_client,
                               "loss_server": out.loss_server,
                               "w_client": out.w_client,
                               "aux": out.aux if is_dtensor(out.aux)
                               else torch.as_tensor(
                                   out.aux, dtype=torch.float32,
                                   device=out.loss_client.device)}
        acc, lc, ls, wc = None, [], [], []
        for mbatch in _microbatches(batch, mb):
            with span("train.microbatch"):
                out = T.tpgf_grads(cfg, params, mbatch, d)
            with span("train.accumulate"):
                if acc is None:
                    acc = tree_map(lambda g: torch.zeros_like(
                        g, dtype=torch.float32), out.grads)
                tree_map(lambda a, g: a.add_(g.float() / mb), acc,
                         out.grads)
            lc.append(out.loss_client)
            ls.append(out.loss_server)
            wc.append(out.w_client)
            del out
        with span("train.accumulate"):
            grads = tree_map(lambda g, p: g.to(p.dtype), acc, params)
        dev = lc[0].device
        metrics = {"loss_client": torch.stack(lc).mean(),
                   "loss_server": torch.stack(ls).mean(),
                   "w_client": torch.stack(wc).mean(),
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}
        return grads, metrics

    def train_step(params, opt_state, batch):
        with span("train.step"):
            grads, metrics = compute_grads(params, batch)
            with span("optim.apply"):
                params, opt_state = apply_in_place(opt, grads, opt_state,
                                                   params)
            # a sharded step's metrics are replicated DTensors: the
            # rank's copy
            metrics = {k: v.to_local() if is_dtensor(v) else v
                       for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, decode_budget: int = 0):
    @torch.no_grad()
    def prefill_step(params, batch):
        return D.prefill(cfg, params, batch, decode_budget=decode_budget)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, token):
        return D.decode_step(cfg, params, cache, token)

    return serve_step


# ------------------------------------------------------------- input specs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Stand-ins for every model input of ``shape`` (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    dt = M.torch_dtype(cfg)
    i32 = torch.int32
    if cfg.family == "vit":
        return {"images": _meta((B, cfg.image_size, cfg.image_size, 3), dt),
                "label": _meta((B,), i32)}
    if cfg.is_encdec:
        return {"frames": _meta((B, cfg.enc_frames, cfg.d_model), dt),
                "tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if cfg.family == "vlm":
        return {"patches": _meta((B, cfg.n_patches, cfg.d_model), dt),
                "tokens": _meta((B, S - cfg.n_patches), i32),
                "labels": _meta((B, S - cfg.n_patches), i32)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def params_specs(cfg: ModelConfig):
    return M.init_params(cfg, None, device="meta")


def cache_specs(cfg: ModelConfig, shape: InputShape):
    return D.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def token_specs(cfg: ModelConfig, shape: InputShape):
    return _meta((shape.global_batch, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Tuple:
    """Abstract args of the step that ``shape.kind`` exercises."""
    if shape.kind == "train":
        _, opt = make_train_step(cfg.replace(use_pallas=False))
        p = params_specs(cfg)
        return (p, opt.init(p), batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return (params_specs(cfg), batch_specs(cfg, shape))
    return (params_specs(cfg), cache_specs(cfg, shape),
            token_specs(cfg, shape))
