"""Reduced cells for the CPU tests: the benchmark's own configuration
and traffic files with the sizes cut, so a cell runs in seconds on the
CPU through the same drivers, references and comparisons."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from harness.spec import BENCH, ROOT, Cell, load_module

VIT_CUT = {"n_layers": 4, "d_model": 32, "n_heads": 4, "n_kv_heads": 4,
           "head_dim": 8, "d_ff": 64, "image_size": 8, "patch_size": 4,
           "n_classes": 6}
MOE_CUT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
           "head_dim": 16, "d_ff": 96, "vocab": 256, "n_experts": 4,
           "top_k": 2, "remat": False, "microbatches": 2}
FLEET_CUT = {"n_clients": 6, "samples": 300, "batch_size": 4,
             "check_units": 3, "profile_units": 1}
LM_CUT = {"batch": 4, "seq_len": 16, "distinct_batches": 8,
          "profile_units": 1}


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def reduced_config(name: str, cut: dict) -> dict:
    c = _json(BENCH / "configs" / f"{name}.json")
    c.update(cut)
    c["reduced"] = sorted(set(c["reduced"]) | set(cut))
    return c


def vit_cell(traffic: str = "fleet48-full", **over) -> Cell:
    t = {**_json(BENCH / "traffic" / f"{traffic}.json"), **FLEET_CUT,
         **over}
    return Cell("vit-test", 1, reduced_config("vit16-cifar", VIT_CUT),
                traffic, t, {}, [], [])


def lm_cell(**over) -> Cell:
    t = {**_json(BENCH / "traffic" / "lm-8x512.json"), **LM_CUT, **over}
    c = reduced_config("mixtral-8x7b-l2", MOE_CUT)
    return Cell("lm-test", 1, c, "lm-8x512", t, {}, [], [])


def with_limits(cell: Cell, limits: dict) -> Cell:
    cell = copy.copy(cell)
    cell.limits = {k: {"limit": v} for k, v in limits.items()}
    return cell


# the ViT cells that PERF.md keeps for later: their files are under
# bench/, their entries are what a later PR adds to BENCHMARK.json
VIT_CELLS = {"vit-ssfl-n48": "fleet48-full",
             "vit-ssfl-n48-width": "fleet48-ladder"}
VIT_RATE = "train_samples_per_s"


def staged_spec() -> dict:
    """BENCHMARK.json with the ViT cells added as entries alone: their
    configuration, cells, rate and the per-layer metrics whose readers
    move that rate (their bound not set)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    vit = _json(BENCH / "configs" / "vit16-cifar.json")
    cells = sorted(VIT_CELLS)
    spec["configs"].append({"name": "vit16-cifar", "source": vit["source"],
                            "file": "bench/configs/vit16-cifar.json",
                            "reduced": vit["reduced"], "why": "staged"})
    spec["workloads"] += [{"name": n, "config": "vit16-cifar",
                           "traffic": t, "chips": 1, "why": "staged"}
                          for n, t in VIT_CELLS.items()]
    spec["end_to_end"].append({"name": VIT_RATE, "unit": "samples/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": cells})
    for path in sorted((BENCH / "metrics").glob("*.py")):
        mod = load_module(path, "staged_" + path.stem.replace(".", "_"))
        if mod.MOVES == VIT_RATE:
            spec["per_layer"].append({
                "name": path.stem, "unit": mod.UNIT, "better": "higher",
                "source": "device_trace", "layer": mod.LAYER,
                "moves": VIT_RATE, "workloads": cells})
    return spec
