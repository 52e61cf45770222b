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
"""
from __future__ import annotations

import contextlib

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
