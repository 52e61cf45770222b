"""Driver: federated rounds of the engine, ``Engine.run_round``.

Set-up draws the cell's inputs from the seed: CIFAR-shaped images on the
card, split over the fleet by Dirichlet(alpha), handed to the engine as
its data; the global model and every client's local head, drawn on the
card and written over the engine's own before the first round. The
engine draws the fleet's profiles, availability and batch indices from
its own seed, the traffic's ``fleet_seed``: the fleet is part of the
mix, so every run trains the same set of depths and widths (a fleet
drawn from ``--seed`` moved the rate by 12 % from seed to seed). The
driver records what the engine drew during the checked rounds (the first
``check_units``, which also warm the engine up), and the reference takes
those draws as inputs.

A unit is one round; its work is the samples the clients trained:
clients that trained × local steps × batch.

The engine is handed a ``Spanned`` strategy: the registry's strategy
behind a thin delegate that keeps each hook's signature. With tracing on,
each call into the strategy layer (``init_round``, ``cohort_step``,
``fold_server``, ``aggregate``) runs in a span of the hook's name
(``harness.spans``), which synchronises at its end, and the driver sums
its host time per round.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness.program import copy_into, model_config
from reference import vit_ssfl as R
from reference.shapes import vit_head_tree, vit_tree
from traffic.generators import class_images, dirichlet_partition
from traffic.weights import draw

# offsets of the driver's own streams from the seed; the engine's own
# streams (fleet, batches, availability) hang off the seed itself
IMAGES, SPLIT, WEIGHTS, HEADS = 101, 102, 103, 104


class Spanned:
    """The registry's strategy behind a delegate that times and records
    the calls into it. Every other attribute is the strategy's own, so
    the hooks the engine inspects (``prepare_fleet``, ``comm_cost``) keep
    their signatures."""

    def __init__(self, inner, spans):
        self.inner, self.spans = inner, spans
        self.cohort_log: List = []       # (depth, ids) of the round
        self.avail = None                # the round's availability draw
        self.recording = False
        self.record: Dict = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _span(self, name, fn, *args, **kwargs):
        if self.spans is None:
            return fn(*args, **kwargs)
        with self.spans(name):
            return fn(*args, **kwargs)

    def init_round(self, engine, ctx):
        if self.spans is not None:
            self.spans.reset()
        self.cohort_log = []
        self.avail = np.array(ctx.avail, bool)
        if self.recording:
            self.record = {"avail": np.array(ctx.avail, bool),
                           "participants": np.array(ctx.participants, bool),
                           "indices": {}}
            draw_indices = ctx.sample_indices

            def recorded(ids, steps, batch_size=None):
                idx = draw_indices(ids, steps, batch_size)
                for j, i in enumerate(np.asarray(ids)):
                    self.record["indices"][int(i)] = idx[:, j].copy()
                return idx
            ctx.sample_indices = recorded
        return self._span("init_round", self.inner.init_round, engine, ctx)

    def cohort_step(self, engine, ctx, ws, d, ids):
        self.cohort_log.append((int(d), np.asarray(ids).copy()))
        return self._span("cohort_step", self.inner.cohort_step, engine, ctx,
                          ws, d, ids)

    def fold_server(self, engine, ws, d, ids, res):
        return self._span("fold_server", self.inner.fold_server, engine, ws,
                          d, ids, res)

    def aggregate(self, engine, ws):
        if self.recording:
            self.record["client_losses"] = ws["losses"].detach().cpu().numpy()
            self.record["trained"] = ws["trained"].detach().cpu().numpy()
        return self._span("aggregate", self.inner.aggregate, engine, ws)


def _log(t0, what):
    print(f"# set-up: {what} at {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}


class Driver:
    UNIT, WORK = "round", "samples"
    RATE_METRIC = "train_samples_per_s"

    def __init__(self, cell, seed: int, device, spans):
        from repro_torch.data.synthetic import ClientData
        from repro_torch.federated import Engine, get_strategy

        c, t = cell.config, cell.traffic
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        t_init = time.perf_counter()
        self.PROFILE_UNITS = int(t["profile_units"])
        n = int(t["n_clients"])
        cfg = model_config(c)
        images, labels, shards = self._inputs()
        host, lab = images.cpu().numpy(), labels.cpu().numpy()
        del images, labels
        data = {"clients": [ClientData(host[s], lab[s].astype(np.int32))
                            for s in shards]}
        del host
        _log(t_init, "inputs drawn")
        self.strategy = Spanned(get_strategy(t["strategy"]), spans)
        self.engine = Engine(
            cfg, n, self.strategy, seed=int(t["fleet_seed"]),
            lr=float(t["lr"]),
            local_steps=int(t["local_steps"]),
            batch_size=int(t["batch_size"]),
            availability=float(t["availability"]),
            sample_frac=float(t["sample_frac"]), optimizer=t["optimizer"],
            data=data, width_tiers=t["width_tiers"],
            cross_tier=t["cross_tier"], device=self.device)
        st = self.engine.state
        copy_into(st.params, draw(vit_tree(c), seed=seed + WEIGHTS,
                                  dtype=torch.float32, device=self.device))
        copy_into(st.local_heads, draw(vit_head_tree(c, n),
                                       seed=seed + HEADS,
                                       dtype=torch.float32,
                                       device=self.device))
        _log(t_init, "engine built, weights written")
        fleet = st.fleet
        self.profiles = ([p.mem_gb for p in fleet.profiles],
                         [p.lat_ms for p in fleet.profiles])
        self.prog_depths = np.asarray(fleet.depths).copy()
        # the checked first rounds, which warm the engine up too
        self.rounds: List[Dict] = []
        self.snapshots: List = []        # after the first and the last
        self.strategy.recording = True
        n_check = int(t["check_units"])
        for r in range(n_check):
            rec = self.engine.run_round()
            self.rounds.append({**self.strategy.record, "loss": rec["loss"],
                                "comm_mb": rec["comm_mb"]})
            if r in (0, n_check - 1):
                self.snapshots.append((_host(st.params),
                                       _host(st.local_heads)))
            _log(t_init, f"checked round {r + 1}")
        self.strategy.recording = False

    def _inputs(self):
        """(images [N, H, W, 3], labels [N], shards): the cell's data,
        drawn from the seed; the images and labels on the card."""
        c, t = self.c, self.t
        images, labels = class_images(
            int(t["samples"]), c["n_classes"], c["image_size"],
            noise=float(t["noise"]), seed=self.seed + IMAGES,
            device=self.device)
        shards = dirichlet_partition(labels.cpu().numpy(),
                                     int(t["n_clients"]), float(t["alpha"]),
                                     seed=self.seed + SPLIT)
        return images, labels, shards

    def run_unit(self) -> Dict:
        t0 = time.perf_counter()
        rec = self.engine.run_round()
        t1 = time.perf_counter()
        t = self.t
        fleet = self.engine.state.fleet
        avail = self.strategy.avail
        clients = [(d, float(fleet.widths[i]), bool(avail[i]))
                   for d, ids in self.strategy.cohort_log for i in ids]
        return {"t0": t0, "t1": t1, "loss": rec["loss"],
                "work": len(clients) * int(t["local_steps"])
                * int(t["batch_size"]),
                "spans": (dict(self.strategy.spans.totals)
                          if self.strategy.spans is not None else {}),
                "clients": clients}

    def end_window(self, units: List[Dict]) -> int:
        return sum(not math.isfinite(u["loss"]) for u in units)

    def release(self) -> None:
        del self.engine, self.strategy
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference(self, prec: str = "fp32", fault=None) -> Dict:
        """The plain reference over the checked rounds' inputs, in
        ``prec`` and with ``fault`` planted (``reference.vit_ssfl``)."""
        c, t, dev = self.c, self.t, self.device
        params = draw(vit_tree(c), seed=self.seed + WEIGHTS,
                      dtype=torch.float32, device=dev)
        heads = draw(vit_head_tree(c, int(t["n_clients"])),
                     seed=self.seed + HEADS, dtype=torch.float32,
                     device=dev)
        fleet = R.Fleet(c, *self.profiles, width_tiers=t["width_tiers"])
        images, labels, shards = self._inputs()
        # the flat dataset in the engine's order: the shards concatenated
        order = torch.as_tensor(np.concatenate(shards), device=dev)
        images, labels = images[order], labels[order]
        p0, h0 = params, heads
        out = {"depths": fleet.depths, "loss": [], "client_losses": [],
               "comm_mb": [], "change": []}
        comm = 0
        for rnd in self.rounds:
            params, heads, r = R.run_round(c, t, params, heads, fleet, rnd,
                                           images, labels, prec, fault)
            comm += r["comm_bytes"]
            out["loss"].append(r["loss"])
            out["client_losses"].append(r["client_losses"])
            out["comm_mb"].append(round(comm / R.MB, 2))
            out["change"].append(R.change_norms(p0, params, h0, heads))
        out["change"] = [out["change"][0], out["change"][-1]]
        return out

    def program(self) -> Dict:
        c, t, dev = self.c, self.t, self.device
        p0 = draw(vit_tree(c), seed=self.seed + WEIGHTS,
                  dtype=torch.float32, device=dev)
        h0 = draw(vit_head_tree(c, int(t["n_clients"])),
                  seed=self.seed + HEADS, dtype=torch.float32, device=dev)
        on = lambda tree: {k: on(v) if isinstance(v, dict) else v.to(dev)
                           for k, v in tree.items()}
        return {"depths": self.prog_depths,
                "loss": [r["loss"] for r in self.rounds],
                "client_losses": [
                    {i: float(r["client_losses"][i])
                     for i in np.where(r["trained"])[0]}
                    for r in self.rounds],
                "comm_mb": [r["comm_mb"] for r in self.rounds],
                "change": [R.change_norms(p0, on(p), h0, on(h))
                           for p, h in self.snapshots]}

    @staticmethod
    def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
        from harness.compare import norm_gap, rel_gap
        client = 0.0
        for pr, rf in zip(prog["client_losses"], ref["client_losses"]):
            if set(pr) != set(rf):
                client = math.inf
                break
            client = max([client] + [rel_gap(pr[i], rf[i]) for i in rf])
        return {
            "depths_differ": float(np.sum(np.asarray(prog["depths"])
                                          != np.asarray(ref["depths"]))),
            "loss_gap": max(rel_gap(a, b) for a, b in
                            zip(prog["loss"], ref["loss"])),
            "client_loss_gap": client,
            "change1_gap": norm_gap(prog["change"][0], ref["change"][0])[0],
            "change3_gap": norm_gap(prog["change"][-1],
                                    ref["change"][-1])[0],
            "comm_mb_gap": max(abs(a - b) for a, b in
                               zip(prog["comm_mb"], ref["comm_mb"])),
        }

    def check(self) -> Dict[str, float]:
        prog = self.program()
        return self.compare(prog, self.reference("fp32"))
