"""The port stands alone: no file under ``src/repro_torch/``, and not
``chip_smoke.py``, the port's examples (``examples/*_torch.py``), its
tools (``tools/*_torch.py``) or the multi-rank test children
(``tests/_torch_multidevice_child.py``, ``tests/_torch_lm_mesh_child.py``),
imports ``jax`` or the JAX package ``repro``; and
``import repro_torch`` (every module of it) works in a fresh interpreter
where ``jax`` and ``repro`` cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + sorted((ROOT / "tools").glob("*_torch.py"))
            + [ROOT / "tests" / "_torch_multidevice_child.py",
               ROOT / "tests" / "_torch_lm_mesh_child.py"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*")}
    for want in ("csrc/tpgf_fusion.cu", "csrc/layer_aggregate.cu",
                 "csrc/flash_attention.cu", "csrc/ssd_scan.cu",
                 "kernels/tpgf_fusion/ops.py", "kernels/layer_aggregate/ops.py",
                 "kernels/flash_attention/ops.py", "kernels/ssd_scan/ops.py",
                 "federated/engine.py", "bridge.py",
                 "federated/strategies/splitfed.py",
                 "federated/strategies/fedavg.py", "checkpoint/ckpt.py",
                 "launch/steps.py", "launch/train.py",
                 "federated/strategies/unstable.py",
                 "federated/strategies/async_buffered.py",
                 "federated/strategies/hasfl.py", "federated/buffer.py",
                 "federated/round.py", "federated/sanitize.py",
                 "roofline/analysis.py", "analysis/fleetlint.py",
                 "launch/mesh.py", "launch/sharding.py",
                 "launch/dryrun.py", "models/sharded.py"):
        assert want in names, want
    for example in ("quickstart_torch.py", "fault_tolerance_torch.py"):
        assert (ROOT / "examples" / example).exists(), example


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'repro_torch.federated.engine' in mods\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('OK', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK"), out.stdout
