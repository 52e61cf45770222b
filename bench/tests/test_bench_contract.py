"""BENCHMARK.json against the benchmark's contract, every file a cell's
name leads to, and the isolation of what runs on the card from JAX, the
JAX package and (for the reference) the program."""
import json
import re
import subprocess
import sys

import pytest

from bench_cells import VIT_CELLS
from harness.spec import BENCH, ROOT, load_cell, metric_module

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        names += [w["config"], w["traffic"]]
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in SPEC["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        # every per-layer metric names the cells it is read in
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]]
                         + sorted(VIT_CELLS))
def test_every_file_a_cell_names(staged, cell):
    spec = json.loads(staged.read_text())
    c = load_cell(staged, cell)
    assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.limits, f"bench/workloads/{cell}.json holds no limits"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        metric_module(c, m)          # declares the entry's layer, unit, moves
    entry = next(x for x in spec["configs"]
                 if x["name"] == next(w for w in spec["workloads"]
                                      if w["name"] == cell)["config"])
    assert c.config["reduced"] == entry["reduced"]
    assert c.config["source"] == entry["source"]


def test_layers_are_spelled_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PATHS = (f"import sys, json; sys.path[:0] = [{str(BENCH)!r}, "
         f"{str(ROOT / 'src')!r}]; ")


def test_nothing_imports_jax_or_the_jax_package():
    mods = _modules_after(
        PATHS + "import harness.runner, harness.spec, calibrate; "
        "from harness.spec import load_module, BENCH; "
        "[load_module(p, 'd_' + p.stem) for p in "
        "sorted((BENCH / 'drivers').glob('*.py'))]; "
        "[load_module(p, 'm_' + p.stem.replace('.', '_')) for p in "
        "sorted((BENCH / 'metrics').glob('*.py'))]; "
        "import reference.vit_ssfl, reference.lm_tpgf, traffic.weights, "
        "traffic.generators, yardstick.flops, yardstick.work; "
        "import repro_torch.federated, repro_torch.launch.steps; "
        "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))")
    # whole top-level names: repro_torch begins with repro but is not it
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods
    assert "repro_torch" in mods


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        PATHS + "import reference.vit_ssfl, reference.lm_tpgf, "
        "reference.precision, reference.shapes, traffic.weights, "
        "traffic.generators, yardstick.flops, yardstick.work, yardstick.hw, "
        "harness.compare; "
        "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))")
    assert not mods & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
