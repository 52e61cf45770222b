"""The program's side of a run: its configuration built from a
configuration file, and the benchmark's weights handed to it."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def model_config(c: Dict):
    """The program's ``ModelConfig`` with every field the file states.
    The fields that differ from the port's own module for this model must
    be those the file lists in ``reduced`` (cuts of scale) or ``set``
    (what the benchmark runs differently, with its reason)."""
    from repro_torch.configs.base import ModelConfig, get_config
    fields = {f.name: c[f.name] for f in dataclasses.fields(ModelConfig)}
    fields["batch_shard_axes"] = tuple(fields["batch_shard_axes"])
    cfg = ModelConfig(**fields)
    base = dataclasses.asdict(get_config(c["port_config"]))
    base["batch_shard_axes"] = tuple(base["batch_shard_axes"])
    changed = {k for k, v in dataclasses.asdict(cfg).items() if base[k] != v}
    allowed = set(c["reduced"]) | set(c["set"])
    if changed - allowed:
        raise ValueError(f"configuration differs from {c['port_config']} "
                         f"in {sorted(changed - allowed)}, which the file "
                         "neither reduces nor sets")
    return cfg


@torch.no_grad()
def copy_into(dst: Dict, src: Dict, where: str = "") -> None:
    """Write every leaf of ``src`` into the same leaf of ``dst`` in place;
    the trees must match key for key, shape for shape and dtype for
    dtype."""
    if set(dst) != set(src):
        raise ValueError(f"{where or 'tree'}: keys {sorted(dst)} vs "
                         f"{sorted(src)}")
    for k, v in src.items():
        if isinstance(v, dict):
            copy_into(dst[k], v, f"{where}/{k}")
            continue
        d = dst[k]
        if d.shape != v.shape or d.dtype != v.dtype:
            raise ValueError(f"{where}/{k}: {tuple(d.shape)} {d.dtype} vs "
                             f"{tuple(v.shape)} {v.dtype}")
        d.copy_(v)
