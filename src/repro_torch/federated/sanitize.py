"""The sanitizer mode (``Engine(sanitize=True)``): a debug tool for a
fleet that diverges.

The reference instruments each bucket kernel with ``checkify``
(``federated/bucketing.py``: ``FleetKernel.sanitized``, ``guard_gather``,
``sanitize_failure``). Its float checks trip when any primitive returns a
NaN and on any division whose divisor holds a zero; its one user check
asserts that the on-device batch gather stays in bounds. A trip raises
:class:`SlotSanitizerError`, whose ``slots`` name the cohort positions
whose outputs came back non-finite.

The port has no traced kernel to instrument, so it checks eagerly:

* :func:`guard_gather` checks the batch indices on the host, before they
  reach the device. On the card an out-of-bounds index that reaches a
  gather raises a device-side assert, which leaves the CUDA context
  unusable, so this is the only check a run survives. PyTorch wraps a
  negative index silently, so a negative one trips it too.
* :class:`FloatCheck` is a dispatch mode that ORs, for every op a
  cohort runs (the backward's included), ``isnan(out).any()`` of each
  floating output, and ``(divisor == 0).any()`` of every division, into
  on-device flags. It reads them once, when the cohort ends: one host
  sync per cohort, as the reference's ``err.get()`` is one per kernel
  call. It only reads, so a healthy sanitized round is bit for bit the
  unsanitized one. Factory ops (``empty*``) are exempt, since their
  outputs are uninitialised until a kernel writes them, and so are views,
  which make no value. The hand-written kernels write through ``ctypes``
  and are invisible to the mode; a NaN they write trips at the next op
  that reads it.

A float trip raises when the step has ended, and the strategies write a
cohort's outputs (client rows, local heads, server moments) into the
engine's state in place, so they are there when it raises; the
reference raises before its strategy reads the kernel's outputs
(departure (g)). A tripped engine is for diagnosis. The gather guard
raises before anything is written, and the next round runs.

On a fleet mesh each rank checks the clients it trains, and a trip on
one rank raises on every rank: after each cohort the ranks all-reduce
their per-position non-finite flags and their trip flag (one collective
per cohort, in this mode only), so no rank is left waiting in the next
collective, and ``slots`` names global cohort positions on every rank.

With ``sanitize=False`` none of this runs: no mode, no sync, no extra op.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import sharding as SH
from repro_torch.tree import tree_leaves

aten = torch.ops.aten

# outputs that hold uninitialised memory until something writes them
_FACTORY_OPS = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.empty_permuted,
    aten.new_empty, aten.new_empty_strided, aten.resize_, aten.resize_as_,
    aten.set_})
# ops whose second operand (or, for reciprocal, only operand) divides
_DIV_OPS = frozenset({aten.div, aten.div_, aten.reciprocal,
                      aten.reciprocal_})
# flags stacked into one tensor every this many, so a long cohort holds
# one byte per op
_CHUNK = 4096


class SlotSanitizerError(RuntimeError):
    """A sanitizer check tripped.

    ``slots`` is the tuple of cohort positions (indices into the cohort's
    ``ids``) whose outputs came back non-finite. Empty when the failure
    left no non-finite trace in them (an out-of-bounds batch index caught
    before the gather)."""

    def __init__(self, message: str, slots=()):
        super().__init__(message)
        self.slots = tuple(slots)


def guard_gather(idx: np.ndarray, size: int,
                 what: str = "batch gather") -> np.ndarray:
    """``idx`` unchanged if every index lies in ``[0, size)``, else raise
    :class:`SlotSanitizerError` (no slots)."""
    a = np.asarray(idx)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= size):
        raise SlotSanitizerError(
            f"{what}: index out of bounds [0, {int(size)})", slots=())
    return idx


def nonfinite_slots(outputs: Any, n: int) -> Tuple[int, ...]:
    """Positions ``j < n`` at which any floating leaf of ``outputs`` that
    leads with the cohort's axis (``shape[0] == n``) holds a non-finite
    value. Reads the leaves to the host: called only after a trip."""
    bad = set()
    for leaf in tree_leaves(outputs):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1
                and leaf.shape[0] == n and leaf.is_floating_point()):
            ok = torch.isfinite(leaf.detach().reshape(n, -1)).all(dim=1)
            bad |= {int(j) for j in torch.nonzero(~ok.cpu()).flatten()}
    return tuple(sorted(bad))


def _float_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (list, tuple)):
        return [t for t in out
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return []


class FloatCheck(TorchDispatchMode):
    """Within ``with FloatCheck() as check:``, flag every NaN an op
    returns and every division by a zero; :meth:`failure` then names the
    first (or gives None). A check of a CPU tensor is read at once; a
    check of a card tensor stays on the card until :meth:`failure`."""

    def __init__(self):
        super().__init__()
        self._n = 0                 # ops seen
        self._what = []             # (op index, message) per device flag
        self._flags = []            # 0-d bool device tensors, not stacked
        self._stacked = []          # [_CHUNK] bool device tensors
        self._host: Optional[Tuple[int, str]] = None   # first host trip

    def _record(self, bad, what: str) -> None:
        """``bad``: a Python bool or a 0-d bool tensor."""
        if not isinstance(bad, torch.Tensor) or bad.device.type == "cpu":
            if self._host is None and bool(bad):
                self._host = (self._n, what)
        elif bad.device.type != "meta":
            self._what.append((self._n, what))
            self._flags.append(bad)
            if len(self._flags) == _CHUNK:
                self._stacked.append(torch.stack(self._flags))
                self._flags = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _FACTORY_OPS or func.is_view:
            return out
        self._n += 1
        if packet in _DIV_OPS:
            divisor = args[0] if packet in (aten.reciprocal,
                                            aten.reciprocal_) else args[1]
            zero = divisor == 0
            self._record(zero.any() if isinstance(zero, torch.Tensor)
                         else zero, f"division by zero in {func}")
        for t in _float_tensors(out):
            self._record(torch.isnan(t).any(), f"nan generated by {func}")
        return out

    def failure(self) -> Optional[str]:
        """The message of the first check that tripped, or None. Reads the
        device flags: the one host sync of a cohort."""
        first = self._host
        flags = self._stacked + ([torch.stack(self._flags)]
                                 if self._flags else [])
        if flags:
            hit = torch.nonzero(torch.cat(flags)).flatten().cpu()
            if hit.numel():
                dev = self._what[int(hit[0])]
                if first is None or dev[0] < first[0]:
                    first = dev
        return None if first is None else first[1]


def checked_cohort_step(engine, ctx, ws, d: int, ids: Sequence[int]):
    """``engine.strategy.cohort_step`` under :class:`FloatCheck`; on a trip,
    raise :class:`SlotSanitizerError` naming the reference's kernel for
    the strategy and the cohort positions whose outputs
    (``strategy.slot_outputs``) are non-finite. An exception raised inside
    the step (a failed launch, an out-of-bounds index) passes as itself."""
    strat = engine.strategy
    with FloatCheck() as check:
        res = strat.cohort_step(engine, ctx, ws, d, ids)
    msg = check.failure()
    if engine.fleet_shards > 1:
        msg, slots = _fleet_verdict(engine, ws, ids, res, msg)
    elif msg is not None:
        slots = nonfinite_slots(strat.slot_outputs(engine, ws, ids, res),
                                len(ids))
    if msg is None:
        return res
    where = f" (cohort slots {list(slots)})" if slots else ""
    raise SlotSanitizerError(
        f"sanitizer tripped in {strat.kernel_name}{where}: {msg}", slots)


def _fleet_verdict(engine, ws, ids, res, msg: Optional[str]):
    """(message, global slots) of a cohort on a fleet mesh: this rank's
    trip and the cohort positions of its own clients whose outputs are
    non-finite, OR-ed over the ranks in one all-reduce. The message is
    None iff no rank tripped."""
    ids = np.asarray(ids)
    pos = np.where(engine.owned(ids))[0]     # this rank's cohort positions
    flags = torch.zeros(len(ids) + 1, dtype=torch.bool)
    if msg is not None:
        local = nonfinite_slots(
            engine.strategy.slot_outputs(engine, ws, ids, res), len(pos))
        flags[pos[list(local)]] = True
        flags[-1] = True
    flags = SH.fleet_any(flags.to(engine.device),
                         engine.mesh).cpu().numpy()
    if not flags[-1]:
        return None, ()
    if msg is None:
        msg = "a float check tripped on another rank of the fleet mesh"
    return msg, tuple(int(j) for j in np.where(flags[:-1])[0])
