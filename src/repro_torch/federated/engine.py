"""The federated engine: ONE round loop, with the strategy supplying the
method-specific phases (cohort update, server fold, aggregation,
per-client communication cost).

Construction is either direct::

    Engine(cfg, n_clients=16, strategy="ssfl", lr=0.25)

or builder-style::

    engine = (Engine.builder(cfg)
              .clients(16, availability=0.9)
              .optimizer("sgd", lr=0.25)
              .build())

Device: ``device=None`` means ``"cuda"``; without a card that raises and
asks for an explicit ``device="cpu"`` (the CPU tests pass it).

RNG-stream contract — every stream has a fixed offset from ``seed``, and
each is the reference's numpy stream drawn in the reference's order, so
fleets, data, availability and batches agree with the JAX engine draw
for draw:

  seed          — fleet profiles, the synthetic data, the batch stream
                  (``TrainState.rng``, drawn in cohort order); the global
                  params come from a ``torch.Generator`` seeded with it
  seed + 1      — per-client local heads phi_i (``torch.Generator``)
  seed + 7      — server availability (``avail_model``)
  seed + 13     — per-round client sampling (``sample_frac``)
  seed + 21     — client participation (the strategy's arrival process,
                  e.g. ``unstable``'s Markov chain)

Width supernet: ``width_tiers=(0.25, 0.5, 0.75, 1.0)`` snaps each
client's memory budget onto the ladder (``allocate_widths``) into
``fleet.widths``; ``cross_tier`` says how a mixed-width cohort's tiers
meet on the shared server branch: ``"fused"`` (the paper's path, ONE
``fuse_tiers`` update from one snapshot) or ``"chained"`` (each tier
continues from the previous one's server branch, the comparator).

``save`` persists the position of every stream (with the Markov on/off
state, the staleness and server-update counters, and the width tiers)
in the checkpoint manifest;
``restore`` rewinds them, so a resumed run is bit-identical to an
uninterrupted one. The manifest is the reference's: a checkpoint written
by either package restores in the other.

``sanitize=True`` is the debug mode for a fleet that diverges
(``federated/sanitize.py``): the batch indices are bounds-checked on the
host before they reach the device, and every cohort step runs under a
float check that flags an op's NaN output or a division by zero; a trip
raises ``SlotSanitizerError`` with the cohort positions whose outputs are
non-finite. A healthy sanitized round is bit for bit the unsanitized one.
With ``sanitize=False`` (the default) an out-of-bounds batch index on the
card is a device-side assert, which the CUDA context does not survive
(the reference's JAX gather clamps it).

Not ported yet, raising ``NotImplementedError`` with its ROADMAP queue
item: ``mesh=`` (fleet sharding).
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import allocation as AL
from repro_torch.core.fault import ArrivalProcess, AvailabilityModel
from repro_torch.data.synthetic import as_device_data, make_federated_data
from repro_torch.device import resolve_device
from repro_torch.federated import metrics as MET
from repro_torch.federated.sanitize import checked_cohort_step, guard_gather
from repro_torch.federated.simulator import make_fleet
from repro_torch.federated.state import TrainState, init_train_state
from repro_torch.federated.strategies import (RoundContext, Strategy,
                                              get_strategy)
from repro_torch.models import model as M
from repro_torch.models.model import local_predict, predict
from repro_torch.optim import Optimizer, get_optimizer


class Engine:
    def __init__(self, cfg: ModelConfig, n_clients: int,
                 strategy: Union[str, Strategy] = "ssfl", *,
                 seed: int = 0, lr: float = None, local_steps: int = 2,
                 batch_size: int = 16,
                 availability: Union[float, ArrivalProcess] = 1.0,
                 participation: ArrivalProcess = None,
                 sample_frac: float = 1.0,
                 optimizer: Union[str, Optimizer] = "sgd",
                 data=None, device_model: MET.DeviceModel = None,
                 alpha: float = 0.5, noise: float = 0.35,
                 mesh=None, sanitize: bool = False, width_tiers=None,
                 cross_tier: str = "fused", device=None):
        assert 0.0 < sample_frac <= 1.0
        M.check_family(cfg)
        if cfg.family != "vit":
            raise NotImplementedError(
                f"Engine: family={cfg.family!r}: the engine feeds image "
                "batches only, as the reference's Engine does (its first "
                "round fails on an LM config); train an LM family with "
                "repro_torch.launch.steps.make_train_step or "
                "python -m repro_torch.launch.train")
        if cross_tier not in ("fused", "chained"):
            raise ValueError(
                f"cross_tier={cross_tier!r}: expected 'fused' or 'chained'")
        self.cross_tier = cross_tier
        if mesh is not None:
            raise NotImplementedError(
                "Engine(mesh=): fleet sharding is ROADMAP queue 1, "
                "\"Fleet sharding and multi-device\"")
        self.sanitize = bool(sanitize)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = (get_strategy(strategy)
                         if isinstance(strategy, str) else strategy)
        if isinstance(optimizer, str):
            lr = 0.05 if lr is None else lr
            self.optimizer = get_optimizer(optimizer, lr)
        else:
            self.optimizer = optimizer
        self.lr, self.local_steps = lr, local_steps
        self.batch_size, self.sample_frac = batch_size, sample_frac
        self.accountant = MET.Accountant(device_model)
        fleet = make_fleet(cfg, n_clients, seed=seed,
                           fixed_depth=self.strategy.fixed_depth(cfg))
        if width_tiers is not None:
            fleet.widths = AL.allocate_widths(
                [p.mem_gb for p in fleet.profiles], width_tiers)
        self._call_prepare_fleet(cfg, fleet)
        self.avail_model: ArrivalProcess = (
            availability if isinstance(availability, ArrivalProcess)
            else AvailabilityModel(availability, seed=seed + 7))
        self._sample_rng = np.random.default_rng(seed + 13)
        self.participation: ArrivalProcess = (
            participation
            or self.strategy.participation_process(cfg, n_clients,
                                                   seed + 21))
        self.data = data or make_federated_data(
            n_clients, n_classes=cfg.n_classes or 10,
            image_size=cfg.image_size, alpha=alpha, seed=seed, noise=noise)
        self.state: TrainState = init_train_state(
            cfg, n_clients, seed=seed, fleet=fleet, device=self.device)
        self._staleness = np.zeros(n_clients, np.int64)
        self._server_updates = 0    # rounds in which any client had a server
        # shape-check caches of the strategies' opt_state slots, reset by
        # restore: the server moments (strategies.base.valid_opt_state),
        # async_buffered's flush moments and its update buffer
        self._server_opt_ok = self._fedopt_ok = self._buffer_ok = None
        self.history: List[Dict] = []

    def _call_prepare_fleet(self, cfg, fleet) -> None:
        """Pass ``device_model`` only to a hook that accepts it, so a
        strategy written against the two-argument ``prepare_fleet(cfg,
        fleet)`` protocol runs unchanged."""
        if _takes(self.strategy.prepare_fleet, "device_model"):
            self.strategy.prepare_fleet(cfg, fleet,
                                        device_model=self.accountant.dm)
        else:
            self.strategy.prepare_fleet(cfg, fleet)

    @classmethod
    def builder(cls, cfg: ModelConfig) -> "EngineBuilder":
        return EngineBuilder(cfg)

    @property
    def device_data(self):
        """The flat device-resident dataset view (built on first use)."""
        return as_device_data(self.data, self.device)

    # ------------------------------------------------------------- one round
    def run_round(self) -> Dict:
        state, strat = self.state, self.strategy
        avail = self.avail_model.draw(state.fleet.n_clients)
        ctx = RoundContext(avail=avail,
                           participants=self._draw_participants(),
                           batch_fn=self._stack_batches,
                           sample_indices=(self._guarded_sample_indices
                                           if self.sanitize
                                           else self._sample_indices),
                           staleness=self._staleness.copy())
        step = checked_cohort_step if self.sanitize else strat.cohort_step
        ws = strat.init_round(self, ctx)
        stats = MET.RoundStats()
        server_busy_s = 0.0
        head_trained = False
        for d, ids in strat.cohorts(self, ctx).items():
            res = step(self, ctx, ws, d, ids)
            strat.fold_server(self, ws, d, ids, res)
            server_busy_s += self._account_cohort(stats, ctx, d, ids, res)
            if res.server_params == 0 or bool(ctx.avail[ids].any()):
                head_trained = True
        stats.round_time_s += server_busy_s
        stats.energy_j += self.accountant.dm.server_power_w * server_busy_s
        state.params, loss = strat.aggregate(self, ws)
        trained = ctx.participants & state.fleet.feasible
        self._staleness = np.where(trained, 0, self._staleness + 1)
        if head_trained:
            self._server_updates += 1
        state.round_idx += 1
        self.accountant.log_round(stats)
        rec = {"round": state.round_idx, "loss": loss,
               **self.accountant.summary()}
        self.history.append(rec)
        return rec

    def _draw_participants(self) -> np.ndarray:
        n = self.state.fleet.n_clients
        if self.sample_frac >= 1.0:
            mask = np.ones(n, bool)
        else:
            k = max(1, int(round(self.sample_frac * n)))
            mask = np.zeros(n, bool)
            mask[self._sample_rng.choice(n, size=k, replace=False)] = True
        if self.participation is not None:
            mask &= self.participation.draw(n)
        return mask

    def _stack_batches(self, ids, batch_size: int = None):
        """The legacy host path: one batch per id, drawn on the host from
        ``state.rng`` in id order and stacked on the device (images
        [len(ids), B, H, W, 3] fp32, labels [len(ids), B] int64). It draws
        what one step of ``_sample_indices`` would, so a strategy uses
        one path or the other per cohort, never both."""
        bs = self.batch_size if batch_size is None else batch_size
        batches = [self.data["clients"][i].sample_batch(bs, self.state.rng)
                   for i in ids]
        return {"images": torch.as_tensor(
                    np.stack([b["images"] for b in batches])).to(self.device),
                "label": torch.as_tensor(
                    np.stack([b["label"] for b in batches]).astype(np.int64)
                ).to(self.device)}

    def _sample_indices(self, ids, steps: int, batch_size: int = None):
        """[steps, len(ids), B] flat-dataset indices from ``state.rng``."""
        bs = self.batch_size if batch_size is None else batch_size
        return self.device_data.sample_indices(ids, steps, bs, self.state.rng)

    def _guarded_sample_indices(self, ids, steps: int,
                                batch_size: int = None):
        """``_sample_indices`` bounds-checked against the flat dataset on
        the host (the sanitizer's gather guard)."""
        return guard_gather(self._sample_indices(ids, steps, batch_size),
                            int(self.device_data.sizes.sum()))

    def _account_cohort(self, stats: MET.RoundStats, ctx: RoundContext,
                        d: int, ids, res) -> float:
        """Method-independent cost model over one cohort (host arithmetic
        over profile scalars); returns the server busy-time contribution."""
        dm = self.accountant.dm
        # a co-tuning strategy reports its cohort's per-step tokens
        n_tok = res.tokens_per_batch or self.tokens_per_batch()
        cflops = MET.dense_train_flops(res.client_params, n_tok) \
            * self.local_steps
        if _takes(self.strategy.comm_cost, "ids"):
            cost = {av: self.strategy.comm_cost(self, d, av, ids=ids)
                    for av in (True, False)}
        else:   # the three-argument protocol: shared scalars
            cost = {av: self.strategy.comm_cost(self, d, av)
                    for av in (True, False)}

        def pick(v, j):
            a = np.asarray(v).reshape(-1)   # per-id array or a shared scalar
            return int(a[j]) if a.size > 1 else int(a[0])

        for j, i in enumerate(ids):
            prof = self.state.fleet.profiles[i]
            pbytes, nmsg = cost[bool(ctx.avail[i])]
            nbytes, nmsg = pick(pbytes, j), pick(nmsg, j)
            t = cflops / dm.client_speed(prof.mem_gb) + dm.comm_time_s(
                nbytes, prof.lat_ms, nmsg)
            stats.comm_bytes += nbytes
            stats.client_flops += cflops
            stats.round_time_s = max(stats.round_time_s, t)
            stats.energy_j += dm.client_power_w * t
            stats.n_messages += nmsg
        sflops = MET.dense_train_flops(res.server_params, n_tok) \
            * self.local_steps * len(ids)
        stats.server_flops += sflops
        return sflops / (dm.server_gflops * 1e9)

    # -------------------------------------------------------------- utilities
    def tokens_per_batch(self) -> int:
        return self.batch_size * self.tokens_per_sample()

    def tokens_per_sample(self) -> int:
        cfg = self.cfg
        return (cfg.image_size // cfg.patch_size) ** 2

    def smashed_bytes(self, d: int) -> int:
        # activations cross the wire in the model's compute dtype
        itemsize = torch.empty((), dtype=M.torch_dtype(self.cfg)).element_size()
        return self.tokens_per_batch() * self.cfg.d_model * itemsize

    @torch.no_grad()
    def evaluate(self, max_batches: int = 8, *, head: str = "auto") -> float:
        """Test accuracy of the current global model.

        head="global" — the server-side classifier (paper's main metric).
        head="local"  — fault-tolerant client-side ensemble: each client
                        runs its depth-d_i prefix + its phi_i head, logits
                        are averaged (paper §II-C inference).
        head="auto"   — "global" once any round has trained the global
                        head, else "local" (the Table III 0% row).
        """
        if head not in ("auto", "global", "local"):
            raise ValueError(head)
        if head == "auto":
            head = "global" if self._server_updates > 0 else "local"
        cfg = self.cfg
        test = self.data["test"]
        bs = 64
        correct = total = 0
        for i in range(0, min(len(test.labels), max_batches * bs), bs):
            batch = {"images": torch.as_tensor(test.images[i:i + bs],
                                               device=self.device),
                     "label": torch.as_tensor(
                         test.labels[i:i + bs].astype(np.int64),
                         device=self.device)}
            if head == "global":
                logits = predict(cfg, self.state.params, batch)
            else:
                logits = self._local_ensemble_logits(batch)
            pred = logits.argmax(dim=-1).cpu().numpy()
            correct += int((pred == test.labels[i:i + bs]).sum())
            total += len(pred)
        return correct / max(total, 1)

    def _local_ensemble_logits(self, batch):
        """Mean of per-client fault-tolerant head logits, each at the
        client's own split depth with its own phi_i; the global head when
        no client is feasible."""
        fleet = self.state.fleet
        acc = None
        n = 0
        for i in range(fleet.n_clients):
            if not fleet.feasible[i]:
                continue
            params = {**self.state.params, **self.state.head_for(i)}
            logits = local_predict(self.cfg, params, batch,
                                   int(fleet.depths[i]))
            acc = logits if acc is None else acc + logits
            n += 1
        if acc is None:
            return predict(self.cfg, self.state.params, batch)
        return acc / n

    def train(self, n_rounds: int, *, eval_every: int = 5,
              target_accuracy: float = None, verbose: bool = False):
        for r in range(n_rounds):
            rec = self.run_round()
            if (r + 1) % eval_every == 0 or r == n_rounds - 1:
                rec["accuracy"] = self.evaluate()
                if verbose:
                    print(f"[{self.strategy.name}] round {rec['round']} "
                          f"loss={rec['loss']:.3f} acc={rec['accuracy']:.3f}")
                if target_accuracy and rec["accuracy"] >= target_accuracy:
                    return rec
        return self.history[-1]

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str, *, meta: Dict = None) -> None:
        """``TrainState.save`` plus the engine's own stream positions
        (availability, sampling and participation RNGs, staleness and
        server-update counters, width tiers), so :meth:`restore` resumes
        bit-identically. Strategy state that lives in
        ``TrainState.opt_state`` (the server moments) rides along. The
        metrics ledger and history are not saved: a restored engine
        accounts from zero."""
        meta = dict(meta or {})
        streams = {"avail": self.avail_model.get_state(),
                   "sample": self._sample_rng.bit_generator.state,
                   "staleness": self._staleness.tolist(),
                   "server_updates": self._server_updates,
                   "widths": np.asarray(self.state.fleet.widths,
                                        np.float64).tolist()}
        if self.participation is not None:
            streams["participation"] = self.participation.get_state()
        meta["engine_streams"] = streams
        self.state.save(path, meta=meta)

    def restore(self, path: str) -> "Engine":
        """Inverse of :meth:`save`; the engine must have been built with
        the same (cfg, n_clients, strategy, optimizer) shape."""
        self.state.restore(path)
        # the adopted opt_state is re-validated by its owners on next use
        self._server_opt_ok = self._fedopt_ok = self._buffer_ok = None
        streams = self.state.last_restore_meta.get("engine_streams")
        if streams:
            self.avail_model.set_state(streams["avail"])
            self._sample_rng.bit_generator.state = streams["sample"]
            self._staleness = np.asarray(streams["staleness"], np.int64)
            self._server_updates = int(streams.get("server_updates", 0))
            if "widths" in streams:
                self.state.fleet.widths = np.asarray(streams["widths"],
                                                     np.float64)
            if self.participation is not None \
                    and "participation" in streams:
                self.participation.set_state(streams["participation"])
        return self


def _takes(hook, name: str) -> bool:
    """Whether ``hook`` accepts the keyword ``name`` (or ``**kwargs``):
    the probe that keeps strategies written against the reference's older
    hook signatures running."""
    params = inspect.signature(hook).parameters
    return name in params or any(p.kind == p.VAR_KEYWORD
                                 for p in params.values())


class EngineBuilder:
    """Fluent construction for the common quickstart path."""

    def __init__(self, cfg: ModelConfig):
        self._cfg = cfg
        self._kw: Dict = {"n_clients": 8}

    def clients(self, n: int, *,
                availability: Union[float, ArrivalProcess] = 1.0,
                sample_frac: float = 1.0,
                participation: ArrivalProcess = None) -> "EngineBuilder":
        self._kw.update(n_clients=n, availability=availability,
                        sample_frac=sample_frac, participation=participation)
        return self

    def strategy(self, name: Union[str, Strategy]) -> "EngineBuilder":
        self._kw["strategy"] = name
        return self

    def optimizer(self, name: Union[str, Optimizer], *, lr: float = None,
                  **opt_kw) -> "EngineBuilder":
        if isinstance(name, str):
            lr = 0.05 if lr is None else lr
            self._kw.update(optimizer=get_optimizer(name, lr, **opt_kw),
                            lr=lr)
        else:
            self._kw["optimizer"] = name
            if lr is not None:
                self._kw["lr"] = lr
        return self

    def data(self, *, alpha: float = 0.5, noise: float = 0.35,
             dataset=None) -> "EngineBuilder":
        self._kw.update(alpha=alpha, noise=noise, data=dataset)
        return self

    def rounds(self, *, local_steps: int = 2, batch_size: int = 16,
               seed: int = 0) -> "EngineBuilder":
        self._kw.update(local_steps=local_steps, batch_size=batch_size,
                        seed=seed)
        return self

    def device_model(self, dm: MET.DeviceModel) -> "EngineBuilder":
        self._kw["device_model"] = dm
        return self

    def execution(self, *, device=None, mesh=None, sanitize: bool = False,
                  width_tiers=None,
                  cross_tier: str = "fused") -> "EngineBuilder":
        """The device to run on (None = the card), the sanitizer mode
        (``sanitize=True``: the gather guard and the float check on every
        cohort step), the supernet width ladder (e.g. ``(0.5, 1.0)``) and
        the cross-tier mode ("fused" or "chained"), plus the reference's
        fleet mesh, which the port does not run yet (``mesh``)."""
        self._kw.update(device=device, mesh=mesh, sanitize=sanitize,
                        width_tiers=width_tiers, cross_tier=cross_tier)
        return self

    def build(self) -> Engine:
        kw = dict(self._kw)   # builder stays reusable
        return Engine(self._cfg, kw.pop("n_clients"), **kw)
