"""Find a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's entry names its file. Everything else is found by name
under ``bench/``:

* ``traffic/<traffic>.json``: the mix's parameters, and the ``driver``
  (the entry point) that runs it;
* ``drivers/<driver>.py``: one module per entry point, with a ``Driver``;
* ``workloads/<cell>.json``: what belongs to the cell alone, the limits
  of its output comparison and the readings they were set from;
* ``metrics/<metric>.py``: one reader per per-layer metric, read in
  the cells that its entry names under ``workloads``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict               # the configuration file's contents
    traffic_name: str
    traffic: Dict              # the traffic file's contents
    limits: Dict               # {number: limit} of the output comparison
    end_to_end: List[Dict]     # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]
    bench: Path = BENCH


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(entry: Dict, cell: str) -> bool:
    """An entry with ``workloads`` is in the cells it names; an
    end-to-end entry without is in every cell."""
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(benchmark: Path, cell: str, bench: Path = BENCH) -> Cell:
    """The cell ``cell`` of ``benchmark`` (a BENCHMARK.json), its files
    read from ``bench`` (configuration files by their path from the
    checkout's root, the directory that holds ``bench``)."""
    spec = _load_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in {benchmark}; have "
                       f"{sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(bench.parent / cfg_entry["file"])
    traffic = _load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits_file = bench / "workloads" / f"{cell}.json"
    limits = (_load_json(limits_file).get("limits", {})
              if limits_file.exists() else {})
    unnamed = [m["name"] for m in spec["per_layer"] if "workloads" not in m]
    if unnamed:
        raise ValueError(f"per-layer metrics {unnamed} name no workloads")
    e2e = [m for m in spec["end_to_end"] if _in_cell(m, cell)]
    per_layer = [m for m in spec["per_layer"] if _in_cell(m, cell)]
    return Cell(cell, int(w["chips"]), config, w["traffic"], traffic,
                limits, e2e, per_layer, bench)


def driver_module(cell: Cell):
    name = cell.traffic["driver"]
    return load_module(cell.bench / "drivers" / f"{name}.py",
                       f"bench_driver_{name}")


def metric_module(cell: Cell, entry: Dict):
    """The reader of a per-layer metric; its declared layer, unit and
    ``moves`` must be the BENCHMARK.json entry's."""
    name = entry["name"]
    mod = load_module(cell.bench / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_"))
    for key, attr in (("layer", "LAYER"), ("unit", "UNIT"),
                      ("moves", "MOVES")):
        if getattr(mod, attr) != entry[key]:
            raise ValueError(f"metrics/{name}.py declares {attr} "
                             f"{getattr(mod, attr)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return mod
