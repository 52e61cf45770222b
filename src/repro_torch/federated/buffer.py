"""Server-side buffered-async update buffer (FedBuff-style).

FedBuff (Nguyen et al., Federated Learning with Buffered Asynchronous
Aggregation) decouples client arrival from server application: client
deltas accumulate in a capacity-``K`` server buffer and the global model
moves only when the buffer flushes, each contribution discounted by how
stale it is. Entries here are *cohort* deltas, tagged with the cohort's
staleness and the round they were pushed in.

The state is the reference's fixed-shape tree, kept in
``TrainState.opt_state["update_buffer"]`` and checkpointed with it (either
package restores the other's):

  deltas     — ``[K, ...]`` fp32 over the global parameter tree
  weight     — ``[K]`` fp32 entry weights (trained clients of the cohort)
  staleness  — ``[K]`` fp32 staleness tags
  round      — ``[K]`` int32 push rounds
  count      — int32 scalar, the number of filled slots

Unfilled slots carry weight 0 and are masked out of every flush. ``push``
writes into its preallocated slot in place (K copies of the model are
resident; a functional push would allocate a new buffer per entry) and
``flush`` resets the slots in place. The tags live on the tree's device
and each policy check reads them back to the host (a few bytes).

The flush weighting is ``unstable``'s staleness discount: an entry pushed
with staleness ``s`` and flushed ``a`` rounds later weighs
``n_e * (1 + s + a)^-gamma``, renormalized over the filled slots. Its
weighted sum is the reference's plain ``einsum("n,n...->...")``, no kernel:
the reference computes it outside any Pallas call.

Flush policies (``ready``):

  ``"count"`` — flush when the buffer holds ``capacity`` entries
                (FedBuff's K-arrivals rule; the default);
  ``"round"`` — flush whenever the buffer is non-empty (synchronous; with
                an SGD server at lr 1.0 and one cohort a round this
                recovers ``unstable``);
  ``"age"``   — flush when the oldest entry is ``max_age`` rounds old, or
                the buffer is full.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

SLOT = "update_buffer"   # the TrainState.opt_state key the buffer lives in

POLICIES = ("count", "round", "age")


def init_buffer(template, capacity: int) -> Dict[str, Any]:
    """A fresh buffer: ``capacity`` zeroed fp32 delta slots shaped over
    ``template`` (the global parameter tree; a tree on the ``meta`` device
    gives a buffer that allocates nothing), zero tags and count, all on
    ``template``'s device."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    leaves = tree_leaves(template)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda dtype, *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return {
        "deltas": tree_map(lambda x: zeros(torch.float32, capacity,
                                           *x.shape), template),
        "weight": zeros(torch.float32, capacity),
        "staleness": zeros(torch.float32, capacity),
        "round": zeros(torch.int32, capacity),
        "count": zeros(torch.int32),
    }


def capacity_of(buf: Dict[str, Any]) -> int:
    return int(buf["weight"].shape[0])


def fill_count(buf: Dict[str, Any]) -> int:
    return int(buf["count"])


@torch.no_grad()
def push(buf: Dict[str, Any], delta, weight: float, staleness: float,
         round_idx: int) -> Dict[str, Any]:
    """Append one staleness-tagged delta in place and return ``buf``. A
    full buffer drops its OLDEST entry first (ring semantics): a safety net
    for callers that push without flushing; the ``async_buffered`` strategy
    checks ``ready`` after every push, and every policy fires on a full
    buffer."""
    k = capacity_of(buf)
    n = fill_count(buf)
    if n >= k:           # drop-oldest: shift everything one slot left
        roll = lambda x: torch.roll(x, -1, 0)
        buf["deltas"] = tree_map(roll, buf["deltas"])
        for key in ("weight", "staleness", "round"):
            buf[key] = roll(buf[key])
        n = k - 1
    tree_map(lambda b, d: b[n].copy_(d), buf["deltas"], delta)
    buf["weight"][n] = float(weight)
    buf["staleness"][n] = float(staleness)
    buf["round"][n] = int(round_idx)
    buf["count"].fill_(n + 1)
    return buf


def ready(buf: Dict[str, Any], *, policy: str = "count",
          max_age: int = None, round_idx: int = 0) -> bool:
    """Does the buffer flush now? See the module docstring for policies."""
    if policy not in POLICIES:
        raise ValueError(f"unknown flush policy {policy!r}; "
                         f"available: {POLICIES}")
    n = fill_count(buf)
    if n == 0:
        return False
    if policy == "round":
        return True
    if policy == "age":
        if max_age is None:
            raise ValueError("policy='age' requires max_age")
        oldest = int(buf["round"][:n].min())
        return (round_idx - oldest) >= max_age or n >= capacity_of(buf)
    return n >= capacity_of(buf)


@torch.no_grad()
def flush(buf: Dict[str, Any], *, gamma: float = 1.0,
          round_idx: int = 0) -> Tuple[Any, Dict[str, Any]]:
    """Collapse the filled slots into ONE fp32 delta (the convex
    combination of the entries under the staleness discount, each entry's
    staleness being its tag plus its age ``round_idx - push round``), and
    reset the buffer in place. Returns ``(delta_tree, buf)``."""
    from repro_torch.federated.strategies.unstable import staleness_weights
    n = fill_count(buf)
    if n == 0:
        raise ValueError("flush() on an empty buffer")
    k = capacity_of(buf)
    valid = np.arange(k) < n
    age = round_idx - buf["round"].cpu().numpy().astype(np.int64)
    eff = buf["staleness"].cpu().numpy().astype(np.float64) \
        + np.maximum(age, 0)
    w = staleness_weights(buf["weight"].cpu().numpy(), eff, gamma,
                          mask=valid)
    wt = torch.as_tensor(np.asarray(w, np.float32),
                         device=buf["weight"].device)
    delta = tree_map(lambda d: torch.einsum("n,n...->...", wt, d),
                     buf["deltas"])
    tree_map(lambda x: x.zero_(), buf)
    return delta, buf
