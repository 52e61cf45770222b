"""Static analysis of the port (``repro_torch.analysis.fleetlint``).

The runtime half, the sanitizer mode, lives with the engine
(``repro_torch.federated.sanitize`` and ``Engine(sanitize=True)``); this
package holds the static half, stdlib only.
"""
from repro_torch.analysis.fleetlint import (  # noqa: F401
    Finding, lint_paths, lint_source)
