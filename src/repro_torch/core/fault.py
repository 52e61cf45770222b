"""Client/server arrival processes — paper §II-C / Algorithm 3.

The paper evaluates fault tolerance as a server-gradient-availability
fraction (Table III); ``AvailabilityModel`` draws it as i.i.d. Bernoulli
per (client, round) from its own numpy stream, draw for draw as the
reference does. The same protocol serves client participation. The
timeout and Markov processes come with the scenario strategies (ROADMAP
queue 1, "Scenario strategies").

``get_state``/``set_state`` carry a process's stream position as the
reference's JSON-able payload (``{"rng": <bit-generator state>}``), so a
checkpoint manifest written by either package restores the streams in
the other (``Engine.save``/``restore``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


class ArrivalProcess:
    """One boolean draw per (client, round); stateful across rounds."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def draw(self, n_clients: int) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {"rng": self._rng.bit_generator.state}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._rng.bit_generator.state = state["rng"]


class AvailabilityModel(ArrivalProcess):
    """Bernoulli special case: i.i.d. ``fraction`` draws per (client, round).

    ``fraction=1.0`` / ``0.0`` short-circuit without consuming randomness,
    so always-on runs are bit-identical to never drawing at all.
    """

    def __init__(self, fraction: float = 1.0, seed: int = 0):
        assert 0.0 <= fraction <= 1.0
        super().__init__(seed)
        self.fraction = fraction

    def draw(self, n_clients: int) -> np.ndarray:
        if self.fraction >= 1.0:
            return np.ones(n_clients, bool)
        if self.fraction <= 0.0:
            return np.zeros(n_clients, bool)
        return self._rng.random(n_clients) < self.fraction
