"""Spans at the program's layer boundaries, recorded only when a caller
installs a recorder.

    with span("optim.apply"):
        ...

With no recorder installed, ``span`` returns one shared
``contextlib.nullcontext()``: no allocation, no clock read, no kernel
and no synchronisation, so an untraced run pays one global read a span.
A recorder is any object with ``begin(name)`` and ``end(name)``;
``install(recorder)`` sets it for the whole process and
``install(None)`` clears it. A span's ``end`` runs however its body
leaves, an exception included (among them the internal stop with which
a non-reentrant ``torch.utils.checkpoint`` ends a recomputation early).

The recorder is called from whichever thread runs the span: on CUDA,
autograd's device thread runs the backward passes, and remat's
recomputed forwards inside them, while the calling thread waits, so the
calls still come one at a time and nest.

A span holds the operations its body queues, and a region's backward
runs later, outside it. ``backward_point(name, *xs)`` marks where the
backward pass crosses a region's edge: it returns ``xs`` unchanged, and
where a recorder is installed and autograd records, the backward pass
records the empty span ``name`` (a ``begin`` and its ``end`` at once)
when it has all the gradients of ``xs``. A region's output passed
through ``backward_point("<region>.backward.begin", y)`` and every
tensor that enters it through ``backward_point("<region>.backward.end",
...)`` bound its backward; being empty, the points nest anywhere, and
with no recorder nothing is added to the graph.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recorder = None


class _Span:
    __slots__ = ("recorder", "name")

    def __init__(self, recorder, name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        self.recorder.begin(self.name)

    def __exit__(self, *exc):
        self.recorder.end(self.name)
        return False


def span(name: str):
    """A context manager for the span ``name``: the installed recorder's
    ``begin``/``end`` around its body, or the shared null context."""
    rec = _recorder
    return _NULL if rec is None else _Span(rec, name)


def install(recorder) -> None:
    """Record every later span with ``recorder``; ``None`` stops
    recording."""
    global _recorder
    _recorder = recorder


class _Point(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        rec = _recorder
        if rec is not None:
            rec.begin(ctx.name)
            rec.end(ctx.name)
        return (None,) + grads


def backward_point(name: str, *xs):
    """``xs`` (one tensor: that tensor), passed through a point whose
    backward records the empty span ``name`` once it has every gradient
    of ``xs``; unchanged where no recorder is installed or none of them
    records a gradient."""
    if _recorder is None or not torch.is_grad_enabled() \
            or not any(x.requires_grad for x in xs):
        return xs[0] if len(xs) == 1 else xs
    out = _Point.apply(name, *xs)
    return out[0] if len(xs) == 1 else out
