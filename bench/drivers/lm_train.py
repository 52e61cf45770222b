"""Driver: the LM train step, ``launch.steps.make_train_step``.

Set-up draws the weights on the card from the seed (the configuration's
dtype, one call per leaf), builds the program's train step with the
traffic's AdamW, and makes ``distinct_batches`` batches of Markov-chain
tokens on the host, moved to the card once and cycled. The first
``check_units`` steps, which also warm the step up, are the checked
ones: their metrics, the gradient AdamW got on the first (its first
moment over 1 − b1), and each leaf's change over them are kept before
the window starts.

A unit is one step; its work is its tokens (batch × sequence). A step
returns without waiting for the card; the window's end waits for all of
them, and a step whose losses are not finite counts as failed.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness.program import model_config
from reference import lm_tpgf as R
from reference.shapes import moe_tree
from traffic.generators import markov_lm_batches
from traffic.weights import draw, iter_leaves

WEIGHTS, TOKENS = 201, 202
METRICS = ("loss_client", "loss_server", "w_client")


def _dtype(c):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class Driver:
    UNIT, WORK = "step", "tokens"
    RATE_METRIC = "train_tokens_per_s"

    def __init__(self, cell, seed: int, device, spans):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.model import init_params
        from repro_torch.optim import adamw

        c, t = cell.config, cell.traffic
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        self.traced = spans is not None
        self.PROFILE_UNITS = int(t["profile_units"])
        cfg = model_config(c)
        o = t["optimizer"]
        opt = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"],
                    moment_dtype=c["adam_moment_dtype"])
        self.step_fn, self.opt = make_train_step(cfg, opt)
        self.params = draw(moe_tree(c), seed=seed + WEIGHTS,
                           dtype=_dtype(c), device=self.device)
        meta = init_params(cfg, None, device="meta")
        for path, x in R.flatten(self.params):
            m = _get(meta, path)
            if m.shape != x.shape or m.dtype != x.dtype:
                raise ValueError(f"{'/'.join(path)}: the program expects "
                                 f"{tuple(m.shape)} {m.dtype}")
        self.opt_state = self.opt.init(self.params)
        self.batches = self._batches()
        self.k = 0
        # the checked first steps, which warm the step up too
        self.checked = []
        for s in range(int(t["check_units"])):
            _, _, m = self._step()
            self.checked.append({k: float(m[k]) for k in METRICS})
            if s == 0:
                b1 = o["b1"]
                self.grad1 = R.norms(
                    (p, x.float() / (1.0 - b1))
                    for p, x in R.flatten(self.opt_state["m"]))
        self.change = self._change(self.params)

    def _batches(self):
        t = self.t
        bs = list(markov_lm_batches(self.c["vocab"], int(t["seq_len"]),
                                    int(t["batch"]),
                                    int(t["distinct_batches"]),
                                    seed=self.seed + TOKENS))
        return {k: torch.as_tensor(np.stack([b[k] for b in bs]),
                                   device=self.device)
                for k in ("tokens", "labels")}

    def _step(self):
        i = self.k % self.batches["tokens"].shape[0]
        self.k += 1
        batch = {k: v[i] for k, v in self.batches.items()}
        return self.step_fn(self.params, self.opt_state, batch)

    def _change(self, params) -> Dict[str, float]:
        """Per-part norms of the parameters' change since the seed's draw,
        each initial leaf drawn again in turn."""
        out = {}
        for path, x0 in iter_leaves(moe_tree(self.c), seed=self.seed + WEIGHTS,
                                    dtype=_dtype(self.c),
                                    device=self.device):
            out.update(R.norms([(path, _get(params, path).float()
                                 - x0.float())]))
            del x0
        return out

    def run_unit(self) -> Dict:
        t0 = time.perf_counter()
        _, _, m = self._step()
        rec = {"t0": t0, "work": int(self.t["batch"]) * int(self.t["seq_len"]),
               "metrics": m}
        if self.traced and self.device.type == "cuda":
            torch.cuda.synchronize()
        rec["t1"] = time.perf_counter()
        return rec

    def end_window(self, units: List[Dict]) -> int:
        if not units:
            return 0
        losses = torch.stack([torch.stack([u["metrics"][k] for k in METRICS])
                              for u in units]).cpu().numpy()
        for u in units:
            u["metrics"] = None
        return int(np.sum(~np.isfinite(losses).all(axis=1)))

    def release(self) -> None:
        del self.params, self.opt_state, self.step_fn, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference(self, prec: str = "fp32", fault=None) -> Dict:
        """The plain reference over the checked steps' inputs, in
        ``prec`` and with ``fault`` planted (``reference.lm_tpgf``)."""
        c, t = self.c, self.t
        weights = draw(moe_tree(c), seed=self.seed + WEIGHTS,
                       dtype=_dtype(c), device=self.device)
        tr = R.Trainer(c, weights, t["optimizer"], prec, fault)
        del weights
        out = {"metrics": []}
        for s in range(int(t["check_units"])):
            i = s % self.batches["tokens"].shape[0]
            r = tr.step(self.batches["tokens"][i], self.batches["labels"][i])
            out["metrics"].append({k: float(r[k]) for k in METRICS})
            if s == 0:
                out["grad1"] = R.norms(r["grads"].items())
            del r
        out["change"] = self._change(tr.params())
        del tr
        return out

    def program(self) -> Dict:
        return {"metrics": self.checked, "grad1": self.grad1,
                "change": self.change}

    @staticmethod
    def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
        from harness.compare import norm_gap, rel_gap
        first = zip(prog["metrics"][:1], ref["metrics"][:1])
        return {
            "loss_gap": max(rel_gap(a[k], b[k]) for a, b in
                            zip(prog["metrics"], ref["metrics"])
                            for k in METRICS),
            # the first step alone: before AdamW's sign-like first moves
            # and the routings they flip feed back into the losses
            "loss1_gap": max(rel_gap(a[k], b[k]) for a, b in first
                             for k in METRICS),
            "grad1_gap": norm_gap(prog["grad1"], ref["grad1"])[0],
            # the leaves every token meets: an expert's or the router's
            # gradient comes from the tokens routed there, and rounding
            # flips near-tied routings on either side
            "grad1_dense_gap": norm_gap(prog["grad1"], ref["grad1"],
                                        only=lambda n: "/moe/" not in n)[0],
            "change3_gap": norm_gap(prog["change"], ref["change"])[0],
        }

    def check(self) -> Dict[str, float]:
        return self.compare(self.program(), self.reference("fp32"))

