"""Back-compat shim: the seed's ``FederatedTrainer`` API on the engine.

The JAX package keeps its seed trainer's constructor and attribute
surface as a thin delegate around ``Engine``; this is the port's
counterpart, for code written against that surface. New code should use
``Engine``. Like every entry point of the port, it runs on the card
unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.federated import metrics as MET
from repro_torch.federated.engine import Engine, predict  # noqa: F401


class FederatedTrainer:
    """Thin delegate around :class:`repro_torch.federated.engine.Engine`."""

    def __init__(self, cfg: ModelConfig, n_clients: int, method: str = "ssfl",
                 *, seed: int = 0, lr: float = 0.05, local_steps: int = 2,
                 batch_size: int = 16, availability: float = 1.0,
                 data=None, device_model: MET.DeviceModel = None,
                 alpha: float = 0.5, noise: float = 0.35, device=None):
        if method not in ("ssfl", "sfl", "dfl", "fedavg"):
            raise ValueError(f"FederatedTrainer runs ssfl, sfl, dfl or "
                             f"fedavg, not {method!r}; use Engine")
        self.engine = Engine(cfg, n_clients, strategy=method, seed=seed,
                             lr=lr, local_steps=local_steps,
                             batch_size=batch_size, availability=availability,
                             data=data, device_model=device_model,
                             alpha=alpha, noise=noise, device=device)

    # ------------------------------------------------- delegated attributes
    @property
    def cfg(self) -> ModelConfig:
        return self.engine.cfg

    @property
    def lr(self) -> float:
        return self.engine.lr

    @property
    def local_steps(self) -> int:
        return self.engine.local_steps

    @property
    def batch_size(self) -> int:
        return self.engine.batch_size

    @property
    def rng(self):
        return self.engine.state.rng

    @property
    def method(self) -> str:
        return self.engine.strategy.name

    @property
    def fleet(self):
        return self.engine.state.fleet

    @property
    def params(self):
        return self.engine.state.params

    @params.setter
    def params(self, value):
        self.engine.state.params = value

    @property
    def local_heads(self) -> List:
        """Seed-era surface: a list of per-client phi_i trees (the state
        stores them stacked along a leading client axis)."""
        state = self.engine.state
        return [state.head_for(i) for i in range(state.n_clients)]

    @property
    def accountant(self) -> MET.Accountant:
        return self.engine.accountant

    @property
    def history(self) -> List[Dict]:
        return self.engine.history

    @property
    def data(self):
        return self.engine.data

    @property
    def avail_model(self):
        return self.engine.avail_model

    # --------------------------------------------------- delegated behaviour
    def run_round(self) -> Dict:
        return self.engine.run_round()

    def evaluate(self, max_batches: int = 8) -> float:
        return self.engine.evaluate(max_batches)

    def train(self, n_rounds: int, *, eval_every: int = 5,
              target_accuracy: float = None, verbose: bool = False):
        return self.engine.train(n_rounds, eval_every=eval_every,
                                 target_accuracy=target_accuracy,
                                 verbose=verbose)
