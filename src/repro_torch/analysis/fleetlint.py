"""fleetlint for the port — static analysis of the round path's contracts.

The counterpart of the JAX package's ``analysis/fleetlint.py``: the same
``Finding``, suppression and scope pragmas, ``lint_paths``, ``main`` and
exit codes (0 clean, 1 findings), over the port's sources. Two of the
reference's rules apply to the port as written:

  FL004  determinism on the round path: no ``time.time``-family calls, no
         global ``np.random.*`` state, no unseeded ``default_rng()``, and
         none of torch's global stream: ``torch.rand*`` / ``randn*`` /
         ``randint*`` / ``randperm`` / ``normal``, the in-place
         ``uniform_`` / ``normal_`` / ``bernoulli_``, each without
         ``generator=``, and ``torch.manual_seed``. Every RNG stream must
         be seeded and checkpointable (the ``Engine.save`` stream
         contract).
  FL005  Strategy implementations must match the ``Strategy`` protocol
         hook signatures — including the 3-arg vs ``ids=`` ``comm_cost``
         probe the engine dispatches on, and the sanitizer's
         ``slot_outputs``.

The reference's FL001 (no host sync inside compiled kernel code), FL002
(no raw reduction over padded bucket slots) and FL003 (psum axis names
and kernel pspec coverage) have no counterpart here: the port states no
host-sync contract, has no padded slots (it slices each client's tree at
its depth), and does not shard the fleet yet.

Suppression: append ``# fleetlint: disable=FL004`` (comma-separate for
several codes) to the offending line, followed by a one-line
justification. A ``# fleetlint: scope=fleet`` comment anywhere in a file
marks it as round-path scope for FL004 (fixture corpora).

Stdlib only (``ast`` + ``re``): ``python tools/fleetlint_torch.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------- rules

RULES: Dict[str, str] = {
    "FL004": "nondeterminism ban on the round path",
    "FL005": "Strategy protocol hook signatures",
}

_SUPPRESS_RE = re.compile(r"#\s*fleetlint:\s*disable=((?:FL\d{3})(?:\s*,\s*FL\d{3})*)")
_SCOPE_RE = re.compile(r"#\s*fleetlint:\s*scope=fleet\b")

# time-source calls banned on the round path (FL004)
_TIME_CALLS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
               "monotonic", "monotonic_ns", "now", "utcnow", "today"}
# np.random attributes that are fine on the round path (seeded, explicit
# generator objects — everything else is the hidden global stream)
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "BitGenerator"}
# torch's samplers that draw from the global stream unless handed a
# ``generator=`` (``torch.rand*`` covers rand/randn/randint/randperm and
# their ``_like`` forms), the in-place ones on any tensor, and the global
# stream's seeding
_TORCH_SAMPLERS = {"normal"}
_INPLACE_SAMPLERS = {"uniform_", "normal_", "bernoulli_"}
_TORCH_SEEDING = {"manual_seed", "manual_seed_all", "seed", "seed_all"}

# Strategy protocol hooks: name -> (required positional names after self,
# allowed optional extras — every extra must carry a default)
_PROTOCOL_HOOKS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "init_round": (("engine", "ctx"), ()),
    "cohort_step": (("engine", "ctx", "ws", "d", "ids"), ()),
    "fold_server": (("engine", "ws", "d", "ids", "res"), ()),
    "aggregate": (("engine", "ws"), ()),
    "cohorts": (("engine", "ctx"), ()),
    "fixed_depth": (("cfg",), ()),
    "prepare_fleet": (("cfg", "fleet"), ("device_model",)),
    "participation_process": (("cfg", "n_clients", "seed"), ()),
    "comm_cost": (("engine", "d", "available"), ("ids",)),
    "slot_outputs": (("engine", "ws", "ids", "res"), ()),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str
    line: int
    col: int
    message: str
    fixit: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"{self.message}\n        fix: {self.fixit}")


# ----------------------------------------------------------------- utilities

def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.rand' / 'np.random.rand' for Name/Attribute chains, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


class _Lines:
    """Per-line suppression sets + the file-level scope pragma."""

    def __init__(self, source: str):
        self.suppress: Dict[int, Set[str]] = {}
        self.fleet_scope = False
        for n, line in enumerate(source.splitlines(), 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppress[n] = {c.strip() for c in m.group(1).split(",")}
            if _SCOPE_RE.search(line):
                self.fleet_scope = True

    def allows(self, code: str, line: int) -> bool:
        return code not in self.suppress.get(line, ())


class _Module:
    def __init__(self, path: Path, source: str, rel: str):
        self.path = path
        self.rel = rel
        self.tree = ast.parse(source, filename=str(path))
        self.lines = _Lines(source)
        posix = Path(rel).as_posix()
        # round-path scope (FL004): the federated engine, the core
        # numerics it calls, and the data pipeline feeding the batch stream
        self.fleet_scope = self.lines.fleet_scope or any(
            f"/{pkg}/" in f"/{posix}" or posix.startswith(f"{pkg}/")
            for pkg in ("federated", "core", "data"))


# ------------------------------------------------------------------ FL004

def _check_fl004(mod: _Module, add) -> None:
    if not mod.fleet_scope:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func) or ""
        parts = d.split(".")
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if parts[0] in ("time", "datetime") and parts[-1] in _TIME_CALLS:
            add("FL004", node,
                f"{d}() on the round path — wall-clock time makes rounds "
                "non-reproducible and breaks checkpoint-exact resume",
                "derive schedules from state.round_idx; wall-clock timing "
                "belongs in benchmarks/launch, not federated/ or core/")
        elif len(parts) >= 2 and parts[0] in ("np", "numpy") \
                and parts[-2] == "random" and parts[-1] not in _NP_RANDOM_OK:
            add("FL004", node,
                f"{d}() uses the hidden global numpy stream — it cannot be "
                "saved by Engine.save, so resume is not bit-identical",
                "draw from an explicit seeded np.random.default_rng(seed) "
                "stream wired into the checkpoint (the RNG-stream "
                "contract in federated.engine)")
        elif parts[-1] == "default_rng" and not node.args \
                and not node.keywords:
            add("FL004", node,
                "unseeded default_rng() on the round path — the stream "
                "cannot be reproduced from the construction seed",
                "pass an explicit seed with a fixed offset from the "
                "engine seed (see the RNG-stream contract), and persist "
                "the stream position in Engine.save")
        elif parts[0] == "random" and len(parts) == 2:
            add("FL004", node,
                f"stdlib {d}() global stream on the round path",
                "use a seeded np.random.default_rng(seed) stream that "
                "Engine.save can persist")
        elif parts[0] == "torch" and parts[-1] in _TORCH_SEEDING:
            add("FL004", node,
                f"{d}() reseeds torch's global stream on the round path — "
                "every other draw from it then depends on call order",
                "seed a torch.Generator of the engine's own (a fixed "
                "offset from its seed) and pass it as generator=")
        elif not _has_kw(node, "generator") and (
                (parts[0] == "torch" and len(parts) >= 2
                 and (parts[-1].startswith("rand")
                      or parts[-1] in _TORCH_SAMPLERS))
                or attr in _INPLACE_SAMPLERS):
            name = d or f".{attr}"
            add("FL004", node,
                f"{name}() without generator= draws from torch's hidden "
                "global stream — Engine.save cannot persist it, so resume "
                "is not bit-identical",
                "pass generator= a torch.Generator seeded at a fixed "
                "offset from the engine seed, or draw with numpy from a "
                "checkpointed stream")


# ------------------------------------------------------------------ FL005

def _strategy_class_names(mods: Sequence[_Module]) -> Set[str]:
    """Transitive closure of classes reaching ``Strategy`` (by name) or
    decorated with ``register_strategy`` across the analyzed files."""
    bases: Dict[str, Set[str]] = {}
    seeds: Set[str] = {"Strategy"}
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases[node.name] = {b for b in
                                ((_dotted(x) or "").split(".")[-1]
                                 for x in node.bases) if b}
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if (_dotted(target) or "").split(".")[-1] == \
                        "register_strategy":
                    seeds.add(node.name)
    out = set(seeds)
    changed = True
    while changed:
        changed = False
        for name, bs in bases.items():
            if name not in out and bs & out:
                out.add(name)
                changed = True
    return out


def _sig_problem(fn: ast.FunctionDef, required: Tuple[str, ...],
                 extras: Tuple[str, ...]) -> Optional[str]:
    args = fn.args
    names = [a.arg for a in args.args]
    if not names or names[0] not in ("self", "cls"):
        return "missing self"
    names = names[1:]
    if tuple(names[:len(required)]) != required:
        return f"positional args {tuple(names[:len(required)])!r}"
    tail = names[len(required):]
    n_defaults = len(args.defaults)
    defaulted = set(names[len(names) - n_defaults:]) if n_defaults else set()
    defaulted |= {a.arg for a, d in
                  zip(args.kwonlyargs, args.kw_defaults) if d is not None}
    has_varkw = args.kwarg is not None
    for t in tail:
        if t not in extras and not has_varkw:
            return f"unexpected parameter {t!r}"
        if t not in defaulted:
            return f"parameter {t!r} needs a default"
    for t in [a.arg for a in args.kwonlyargs]:
        if t not in extras and not has_varkw:
            return f"unexpected keyword-only parameter {t!r}"
    return None


def _check_fl005(mod: _Module, strategy_classes: Set[str], add) -> None:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef) or \
                node.name not in strategy_classes:
            continue
        for item in node.body:
            if not isinstance(item, ast.FunctionDef) or \
                    item.name not in _PROTOCOL_HOOKS:
                continue
            required, extras = _PROTOCOL_HOOKS[item.name]
            problem = _sig_problem(item, required, extras)
            if problem:
                opt = "".join(f", {e}=..." for e in extras)
                add("FL005", item,
                    f"{node.name}.{item.name} does not match the Strategy "
                    f"protocol ({problem}) — the engine dispatches on this "
                    "exact signature" + (
                        " (the comm_cost ids= probe)"
                        if item.name == "comm_cost" else ""),
                    f"def {item.name}(self, {', '.join(required)}{opt})")


# --------------------------------------------------------------- entry points

def _lint_module(mod: _Module, strategy_classes: Set[str],
                 select: Optional[Set[str]]) -> List[Finding]:
    findings: List[Finding] = []

    def add(code: str, node: ast.AST, message: str, fixit: str):
        if select and code not in select:
            return
        line = getattr(node, "lineno", 1)
        if not mod.lines.allows(code, line):
            return
        findings.append(Finding(code, mod.rel, line,
                                getattr(node, "col_offset", 0) + 1,
                                message, fixit))

    _check_fl004(mod, add)
    _check_fl005(mod, strategy_classes, add)
    return findings


def _iter_py_files(paths: Iterable[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def _rel(path: Path, roots: Sequence[Path]) -> str:
    for r in roots:
        try:
            return path.resolve().relative_to(Path(r).resolve()).as_posix()
        except ValueError:
            continue
    return str(path)


def lint_paths(paths: Sequence, select: Optional[Iterable[str]] = None
               ) -> List[Finding]:
    """Lint every .py file under ``paths``; returns sorted findings."""
    roots = [Path(p) for p in paths]
    mods: List[_Module] = []
    for f in _iter_py_files(roots):
        mods.append(_Module(f, f.read_text(), _rel(f, roots)))
    sel = set(select) if select else None
    strategy_classes = _strategy_class_names(mods)
    findings: List[Finding] = []
    for mod in mods:
        findings.extend(_lint_module(mod, strategy_classes, sel))
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))


def lint_source(source: str, path: str = "<string>",
                select: Optional[Iterable[str]] = None) -> List[Finding]:
    """Single-module convenience entry point (tests, tooling)."""
    mod = _Module(Path(path), source, path)
    return sorted(_lint_module(mod, _strategy_class_names([mod]),
                               set(select) if select else None),
                  key=lambda f: (f.line, f.code))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="fleetlint_torch",
        description="round-path contract analysis for the PyTorch port")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the "
                             "repro_torch package)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule codes (e.g. FL004)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)
    if args.list_rules:
        for code, title in sorted(RULES.items()):
            print(f"{code}  {title}")
        return 0
    paths = args.paths or [Path(__file__).resolve().parents[1]]
    select = args.select.split(",") if args.select else None
    findings = lint_paths(paths, select=select)
    for f in findings:
        print(f.format())
    n_files = len(_iter_py_files([Path(p) for p in paths]))
    if findings:
        print(f"fleetlint: {len(findings)} finding(s) in {n_files} files")
        return 1
    print(f"fleetlint: clean ({n_files} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
