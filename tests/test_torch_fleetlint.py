"""The port's fleetlint (``repro_torch.analysis.fleetlint``), after
``tests/test_fleetlint.py``.

Held: the port's corpus (``tests/_torch_fleetlint_corpus/``, parsed and
never imported) fires FL004, torch's global stream included, and FL005,
the sanitizer's ``slot_outputs`` hook included, with the counts given,
and its good files are clean; on the reference's own FL004 and FL005
corpus files the port's linter gives the same (code, line) findings as
``repro.analysis.fleetlint``; ``src/repro_torch`` lints clean; every
suppression in it carries a reason; ``main``'s exit codes and the
pragmas behave as the reference's; the hooks FL005 fixed (``comm_cost``'s
``ids`` defaulted) take the three-argument protocol.
"""
from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import fleetlint as JL

from repro_torch.analysis.fleetlint import (RULES, Finding, lint_paths,
                                            lint_source, main)

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "_torch_fleetlint_corpus"
REF_CORPUS = ROOT / "tests" / "_fleetlint_corpus"
SRC = ROOT / "src" / "repro_torch"


def codes_for(path: Path) -> Counter:
    return Counter(f.code for f in lint_paths([path]))


@pytest.mark.parametrize("name,code,count", [
    ("fl004_bad.py", "FL004", 13),   # clock, numpy global, unseeded,
                                     # manual_seed, 6 torch samplers,
                                     # 3 in-place samplers
    ("fl005_bad.py", "FL005", 4),    # extra param, ids without default,
                                     # slot_outputs missing res, child
])
def test_bad_corpus_fires(name, code, count):
    got = codes_for(CORPUS / name)
    assert got[code] == count, f"{name}: {got}"
    assert set(got) == {code}, f"{name} leaked other rules: {got}"


def test_torch_global_stream_calls_are_named():
    msgs = [f.message for f in lint_paths([CORPUS / "fl004_bad.py"])]
    for call in ("torch.manual_seed", "torch.rand(", "torch.randn(",
                 "torch.randint(", "torch.randperm(", "torch.normal(",
                 "torch.randn_like(", ".uniform_(", ".normal_(",
                 ".bernoulli_("):
        assert any(call in m for m in msgs), call


@pytest.mark.parametrize("name", ["fl004_good.py", "fl005_good.py"])
def test_good_corpus_is_clean(name):
    assert lint_paths([CORPUS / name]) == []


@pytest.mark.parametrize("name", ["fl004_bad.py", "fl004_good.py",
                                  "fl005_bad.py", "fl005_good.py"])
def test_reference_corpus_gives_the_reference_findings(name):
    path = REF_CORPUS / name
    want = [(f.code, f.line) for f in JL.lint_paths([path])
            if f.code in RULES]
    assert [(f.code, f.line) for f in lint_paths([path])] == want


def test_suppression_select_and_scope():
    src = ("import time\nimport torch\n"
           "def f(x):\n"
           "    t = time.time()\n"
           "    return torch.randn(3), t\n")
    assert lint_source(src, "tools_helper.py") == []           # out of scope
    assert len(lint_source("# fleetlint: scope=fleet\n" + src,
                           "helper.py")) == 2                  # pragma opts in
    assert len(lint_source(src, "federated/helper.py")) == 2   # path opts in
    hushed = src.replace(
        "torch.randn(3), t",
        "torch.randn(3), t  # fleetlint: disable=FL004 — test")
    assert [f.line for f in lint_source(hushed, "core/h.py")] == [4]
    assert lint_source(src, "data/h.py", select=["FL005"]) == []


def test_finding_format_has_fixit():
    f = Finding("FL004", "a.py", 3, 1, "msg", "do this instead")
    out = f.format()
    assert "a.py:3:1: FL004" in out and "fix: do this instead" in out


# ---------------------------------------------------------- src/repro_torch

def test_src_repro_torch_is_clean():
    assert lint_paths([SRC]) == []


def test_every_suppression_is_justified():
    pragma = re.compile(r"#\s*fleetlint:\s*disable=(FL\d{3}(?:\s*,\s*FL\d{3})*)(.*)$")
    found = 0
    for path in sorted(SRC.rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            m = pragma.search(line)
            if m:
                found += 1
                reason = m.group(2).strip(" —-:")
                assert len(reason) >= 10, f"{path}:{n}: unjustified"
    assert found >= 1     # federated/state.py's empty-shell default_rng()


# ------------------------------------------------------------------ main

def test_main_exit_codes_match_the_reference(capsys):
    for argv in ([str(CORPUS / "fl004_bad.py")],
                 [str(CORPUS / "fl004_good.py")], ["--list-rules"],
                 [str(REF_CORPUS / "fl005_bad.py")]):
        assert main(argv) == JL.main(argv), argv
    assert main([str(SRC)]) == 0
    out = capsys.readouterr().out
    assert "FL004  nondeterminism ban on the round path" in out


def test_tool_defaults_to_the_port():
    r = subprocess.run([sys.executable, "tools/fleetlint_torch.py"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:]
    n = len(list(SRC.rglob("*.py")))
    assert f"fleetlint: clean ({n} files)" in r.stdout


@pytest.mark.parametrize("method", ["ssfl", "sfl", "fedavg"])
def test_comm_cost_takes_the_three_argument_protocol(method):
    # without ``ids`` the cost is one shared scalar, each client's at full
    # width
    from repro_torch.configs.base import get_reduced
    from repro_torch.federated import Engine
    cfg = get_reduced("vit16_cifar").replace(
        n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
        d_ff=96, image_size=16, n_classes=6)
    eng = Engine(cfg, 3, method, device="cpu")
    d = int(eng.state.fleet.depths[0])
    for available in (True, False):
        scalar, msgs = eng.strategy.comm_cost(eng, d, available)
        per_id, id_msgs = eng.strategy.comm_cost(eng, d, available,
                                                 ids=np.arange(3))
        assert np.all(np.asarray(per_id) == scalar)
        assert np.all(np.asarray(id_msgs) == msgs)
