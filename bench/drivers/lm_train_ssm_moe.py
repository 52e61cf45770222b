"""Driver: the LM train step, ``launch.steps.make_train_step``, for the
ssm_moe family (Granite-4.0-H): Mamba-2 and attention layers in a
published order, each followed by the experts held on this card and a
shared expert.

What ``drivers/lm_train_blocked.py`` does, over this family's tree
(``reference.ssm_moe_shapes``), its weights (``traffic/ssm_moe_weights``)
and its plain reference (``reference.ssm_moe_tpgf``). The configuration
is the port's ``SSMMoEConfig``, built from every one of its fields in the
file; as in ``harness.program.model_config``, the fields that differ
from the port's module must be those the file lists in ``reduced`` or
``set``, and the source's keys the file repeats must agree with the
fields they name.

In a traced run the program's spans (``repro_torch.trace``) are
recorded: each edge queues a marker kernel while the profiler runs, and
calls nothing else (no synchronisation), so the per-layer metrics can
read the device time inside a span; ``release`` uninstalls the recorder.

Set-up ends with ``gc.freeze()``, as a long training job does once it
has built its state: the step leaves enough objects alive across the
collector's young generations that a full collection comes every four
steps, and a full collection over the heap the imports and set-up made
held the host 150-185 ms (H100), which the card waits out at the step's
host synchronisation; frozen, that heap is not scanned again.
``release`` unfreezes it.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict

import torch

from drivers import lm_train, lm_train_blocked
from reference import ssm_moe_tpgf as R
from reference.ssm_moe_shapes import ssm_moe_tree
from traffic.ssm_moe_weights import draw, iter_leaves

WEIGHTS = lm_train.WEIGHTS
METRICS = lm_train.METRICS

# the source's config.json keys the file repeats, and the fields they name
SOURCE_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff",
               "vocab_size": "vocab", "num_local_experts": "n_experts",
               "num_experts_per_tok": "top_k", "mamba_d_state": "ssm_state",
               "mamba_expand": "ssm_expand", "mamba_d_head": "ssm_head_dim",
               "mamba_d_conv": "ssm_conv_dim", "layer_types": "layer_kinds",
               "shared_intermediate_size": "shared_expert_ff",
               "embedding_multiplier": "embedding_multiplier",
               "residual_multiplier": "residual_multiplier",
               "attention_multiplier": "attention_multiplier",
               "logits_scaling": "logits_scaling",
               "rms_norm_eps": "rms_norm_eps"}


def ssm_moe_config(c: Dict):
    """The program's ``SSMMoEConfig`` with every field the file states."""
    from repro_torch.configs.base import SSMMoEConfig, get_config
    fields = {f.name: c[f.name] for f in dataclasses.fields(SSMMoEConfig)}
    for k in ("batch_shard_axes", "layer_kinds"):
        fields[k] = tuple(fields[k])
    cfg = SSMMoEConfig(**fields)
    base = get_config(c["port_config"])
    changed = {k for k in fields if getattr(base, k) != getattr(cfg, k)}
    allowed = set(c["reduced"]) | set(c["set"])
    if changed - allowed:
        raise ValueError(f"configuration differs from {c['port_config']} "
                         f"in {sorted(changed - allowed)}, which the file "
                         "neither reduces nor sets")
    apart = [k for k, f in SOURCE_KEYS.items()
             if k in c and type(fields[f])(c[k]) != fields[f]]
    if apart:
        raise ValueError(f"the source's keys {apart} disagree with the "
                         "fields they name")
    return cfg


class _Marks:
    """A recorder for ``repro_torch.trace``: each span's edges become the
    benchmark's marker kernels (``harness.spans.Spans._mark``), queued
    only while the profiler runs."""

    def __init__(self, spans):
        self.spans = spans

    def begin(self, name):
        self.spans._mark(name, "b")

    def end(self, name):
        self.spans._mark(name, "e")


class Driver(lm_train_blocked.Driver):
    FAMILY = R.GRANITE
    norms = staticmethod(R.norms)

    def _draw(self) -> Dict:
        return draw(ssm_moe_tree(self.c), seed=self.seed + WEIGHTS,
                    dtype=lm_train._dtype(self.c), device=self.device)

    def __init__(self, cell, seed: int, device, spans):
        from repro_torch import trace
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.model import init_params
        from repro_torch.optim import adamw

        c, t = cell.config, cell.traffic
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        self.traced = spans is not None
        self.PROFILE_UNITS = int(t["profile_units"])
        cfg = ssm_moe_config(c)
        o = t["optimizer"]
        opt = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"],
                    moment_dtype=c["adam_moment_dtype"])
        self.step_fn, self.opt = make_train_step(cfg, opt)
        self.params = self._draw()
        meta = init_params(cfg, None, device="meta")
        for path, x in R.flatten(self.params):
            m = lm_train._get(meta, path)
            if m.shape != x.shape or m.dtype != x.dtype:
                raise ValueError(f"{'/'.join(path)}: the program expects "
                                 f"{tuple(m.shape)} {m.dtype}")
        if self.traced:
            trace.install(_Marks(spans))
        self.opt_state = self.opt.init(self.params)
        self.batches = self._batches()
        self.k = 0
        self.checked = []
        for s in range(int(t["check_units"])):
            _, _, m = self._step()
            self.checked.append({k: float(m[k]) for k in METRICS})
            if s == 0:
                b1 = o["b1"]
                self.grad1 = R.norms(
                    (p, x.float() / (1.0 - b1))
                    for p, x in R.flatten(self.opt_state["m"]))
        self.change = self._change(self.params)
        gc.collect()
        gc.freeze()

    def _change(self, params) -> Dict[str, float]:
        out = {}
        for path, x0 in iter_leaves(ssm_moe_tree(self.c),
                                    seed=self.seed + WEIGHTS,
                                    dtype=lm_train._dtype(self.c),
                                    device=self.device):
            out.update(R.norms([(path, lm_train._get(params, path).float()
                                 - x0.float())]))
            del x0
        return out

    def release(self) -> None:
        from repro_torch import trace
        trace.install(None)
        gc.unfreeze()
        super().release()

    @staticmethod
    def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
        from harness.compare import norm_gap
        out = lm_train.Driver.compare(prog, ref)
        routed = ("/moe/router", "/moe/w_gate", "/moe/w_up", "/moe/w_down")
        # the leaves every token meets, the Mamba-2 mixers' apart: a
        # routed expert's or the router's gradient comes from the tokens
        # routed there, and rounding flips near-tied routings on either
        # side (the shared expert is not one)
        out["grad1_dense_gap"] = norm_gap(
            prog["grad1"], ref["grad1"],
            only=lambda n: "/mamba/" not in n
            and not any(r in n for r in routed))[0]
        out["grad1_ssm_gap"] = norm_gap(prog["grad1"], ref["grad1"],
                                        only=lambda n: "/mamba/" in n)[0]
        return out
