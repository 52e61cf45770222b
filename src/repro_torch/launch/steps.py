"""Serving step functions of the assembled super-network: the
teacher-forced cache-building forward and the single-token decode.

The JAX package's ``make_train_step`` (the production TPGF train step)
comes with the LM training slice (ROADMAP queue 1, "The LM training
slice"). Both steps
here run without autograd: serving needs no graph, and the flash kernel
has no backward.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D


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
