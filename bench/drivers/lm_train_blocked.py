"""Driver: ``drivers/lm_train.py`` with its plain reference computed in
blocks (``reference/tpgf_blocked.py``), layer by layer, so that it fits
on one card beside its own training state where the whole-graph
reference (``reference/lm_tpgf.py``) does not: Mixtral's block at 2,048
tokens a microbatch. The program's side and the comparison are
``lm_train``'s; the planted half-batch fault leaves out the step's
second half of microbatches, since a microbatch may hold one sequence.

A family driver subclasses this one with its ``FAMILY``, its tree's
weights (``_draw``) and the norms its comparison weighs (``norms``).
"""
from __future__ import annotations

from typing import Dict

from drivers import lm_train
from reference import lm_tpgf
from reference import tpgf_blocked as B
from reference.shapes import moe_tree
from traffic.weights import draw


class Driver(lm_train.Driver):
    FAMILY = B.MIXTRAL
    norms = staticmethod(lm_tpgf.norms)

    def _draw(self) -> Dict:
        """The seed's initial weights, drawn again on the card."""
        return draw(moe_tree(self.c), seed=self.seed + lm_train.WEIGHTS,
                    dtype=lm_train._dtype(self.c), device=self.device)

    def reference(self, prec: str = "fp32", fault=None) -> Dict:
        """The plain reference over the checked steps' inputs, in
        ``prec`` and with ``fault`` planted."""
        t = self.t
        tr = B.Trainer(self.FAMILY, self.c, self._draw(), t["optimizer"],
                       prec, fault)
        out = {"metrics": []}
        for s in range(int(t["check_units"])):
            i = s % self.batches["tokens"].shape[0]
            r = tr.step(self.batches["tokens"][i], self.batches["labels"][i])
            out["metrics"].append({k: float(r[k]) for k in lm_train.METRICS})
            if s == 0:
                out["grad1"] = self.norms(r["grads"].items())
            del r
        out["change"] = self._change(tr.params())
        del tr
        return out
