"""Client/server arrival processes — paper §II-C / Algorithm 3.

The paper evaluates fault tolerance as a server-gradient-availability
fraction (Table III); ``AvailabilityModel`` draws it as i.i.d. Bernoulli
per (client, round) from its own numpy stream, draw for draw as the
reference does. The same protocol serves client participation.
``TimeoutAvailability`` is the deterministic latency-threshold variant of
the paper's RPC timeout; ``MarkovArrivalProcess`` is a per-client on/off
(Gilbert) chain with a deadline-straggler overlay, the participation
process of the ``unstable`` and ``async_buffered`` strategies. All draws
are host numpy, the reference's calls in the reference's order, so a
seed gives the same masks on both sides.

``get_state``/``set_state`` carry a process's stream position as the
reference's JSON-able payload (``{"rng": <bit-generator state>}``, plus
the Markov chain's ``up`` vector), so a
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


class TimeoutAvailability(AvailabilityModel):
    """Latency-threshold variant: the server 'times out' for clients whose
    round-trip latency (plus an optional Gaussian jitter) exceeds
    ``timeout_ms`` — the deterministic analogue of the paper's 5 s RPC
    timeout, scaled to the simulated [20, 200] ms range."""

    def __init__(self, latencies_ms, timeout_ms: float, jitter_ms: float = 0.0,
                 seed: int = 0):
        super().__init__(1.0, seed)
        self.lat = np.asarray(latencies_ms, float)
        self.timeout_ms = timeout_ms
        self.jitter_ms = jitter_ms

    def draw(self, n_clients: int) -> np.ndarray:
        jitter = (self._rng.normal(0.0, self.jitter_ms, n_clients)
                  if self.jitter_ms else 0.0)
        return (self.lat[:n_clients] + jitter) <= self.timeout_ms


class MarkovArrivalProcess(ArrivalProcess):
    """Per-client on/off (Gilbert) chain with a deadline-straggler overlay.

    Each round a client's state goes off -> on with probability ``p_up``
    and on -> off with ``p_down``. The chain starts lazily, on the first
    draw, from its stationary distribution
    ``pi_on = p_up / (p_up + p_down)``. ``straggle_p``: a client whose
    chain is on still sits the round out with that probability (late, not
    gone: the draw does not change the chain's state).
    """

    def __init__(self, p_up: float = 0.5, p_down: float = 0.2,
                 straggle_p: float = 0.0, seed: int = 0):
        assert 0.0 < p_up <= 1.0 and 0.0 <= p_down <= 1.0
        assert 0.0 <= straggle_p < 1.0
        super().__init__(seed)
        self.p_up, self.p_down, self.straggle_p = p_up, p_down, straggle_p
        self._up: np.ndarray = None   # sized on the first draw

    @property
    def stationary_fraction(self) -> float:
        return self.p_up / (self.p_up + self.p_down)

    def draw(self, n_clients: int) -> np.ndarray:
        if self._up is None or len(self._up) != n_clients:
            self._up = self._rng.random(n_clients) < self.stationary_fraction
        else:
            u = self._rng.random(n_clients)
            self._up = np.where(self._up, u >= self.p_down, u < self.p_up)
        joined = self._up.copy()
        if self.straggle_p > 0.0:
            joined &= self._rng.random(n_clients) >= self.straggle_p
        return joined

    def get_state(self) -> Dict[str, Any]:
        s = super().get_state()
        s["up"] = None if self._up is None else self._up.astype(int).tolist()
        return s

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        up = state.get("up")
        self._up = None if up is None else np.asarray(up, bool)
