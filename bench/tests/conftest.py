"""The benchmark's own tests: run from the root of the repository with
``python -m pytest bench/tests``. The harness, the program and these
helpers are imported the way ``bench/run.py`` imports them."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
for p in (str(HERE), str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="session")
def staged(tmp_path_factory):
    """A BENCHMARK.json with the ViT cells PERF.md keeps for later."""
    from bench_cells import staged_spec
    path = tmp_path_factory.mktemp("staged") / "BENCHMARK.json"
    path.write_text(json.dumps(staged_spec()))
    return path
