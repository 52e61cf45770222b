#!/usr/bin/env python3
"""Run the port's fleetlint over its sources without installing anything.

The linter (``repro_torch.analysis.fleetlint``) is stdlib-only, so this
wrapper puts ``src/`` on the path and defaults the target to
``src/repro_torch``:

    python tools/fleetlint_torch.py              # lint src/repro_torch
    python tools/fleetlint_torch.py --list-rules
    python tools/fleetlint_torch.py path/ --select FL004
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.fleetlint import main  # noqa: E402

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not argv or all(a.startswith("-") for a in argv):
        argv = [str(ROOT / "src" / "repro_torch")] + argv
    sys.exit(main(argv))
