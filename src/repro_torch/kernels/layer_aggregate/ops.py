"""Eq. 8 aggregation of client-stacked leaves: the ``aggregate`` CUDA
kernel (``csrc/layer_aggregate.cu``) behind a checked wrapper.

``aggregate_leaf`` takes the plain version (``ref.aggregate``) for a
tensor that lies on the CPU, and only then; for a CUDA tensor it launches
the kernel or raises. ``aggregate_leaf.launches`` counts kernel launches.
``aggregate_numerator`` is the kernel's numerator mode (``sum_n ww c`` in
fp32, no division; plain version ``ref.numerator``), which a fleet mesh's
ranks run on their own rows before one all-reduce; it counts its
launches in ``aggregate_numerator.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.layer_aggregate import ref as R

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLIENTS = 12288   # the weight column is staged in 48 KB of shared memory


def _kernel(name: str = "repro_aggregate"):
    fn = getattr(B.load("layer_aggregate"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                       if name == "repro_aggregate" else
                       [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p]) + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_args(what, c, ww, s=None):
    N, Lk = c.shape[:2]
    if c.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {c.device}")
    if (s is not None and s.shape != c.shape[1:]) \
            or tuple(ww.shape) != (N, Lk):
        raise ValueError(
            f"{what}: c {tuple(c.shape)}, ww {tuple(ww.shape)} and s "
            f"{None if s is None else tuple(s.shape)} must be [N, L, ...], "
            "[N, L] and [L, ...]")
    if ww.dtype != torch.float32:
        raise TypeError(f"{what}: ww must be float32, got {ww.dtype}")
    if c.dtype not in _DTYPE_CODE or (s is not None and c.dtype != s.dtype):
        raise TypeError(f"{what}: c {c.dtype} and s "
                        f"{None if s is None else s.dtype} must share one "
                        "dtype of float32, bfloat16")
    given = [t for t in (c, ww, s) if t is not None]
    if not all(t.device == c.device for t in given):
        raise ValueError(f"{what}: c, ww and s must be on one device")
    if not all(t.is_contiguous() for t in given):
        raise ValueError(f"{what}: c, ww and s must be contiguous")
    if N > MAX_CLIENTS:
        raise ValueError(f"{what}: at most {MAX_CLIENTS} clients, got {N}")


def aggregate_leaf(c, ww, s, lam: float):
    """c [N, L, ...]; ww [N, L] fp32; s [L, ...] -> [L, ...] in s's dtype."""
    N, Lk = c.shape[:2]
    F = math.prod(c.shape[2:])
    if c.device.type == "cpu":
        return R.aggregate(c.reshape(N, Lk, F), ww, s.reshape(Lk, F),
                           lam).reshape(s.shape)
    _check_args("aggregate", c, ww, s)
    out = torch.empty_like(s)
    if F == 0 or Lk == 0:
        return out
    rc = _kernel()(_DTYPE_CODE[c.dtype], c.data_ptr(), ww.data_ptr(),
                   s.data_ptr(), out.data_ptr(), float(lam), N, Lk, F,
                   torch.cuda.current_stream(c.device).cuda_stream)
    B.check(rc, "aggregate")
    aggregate_leaf.launches += 1
    return out


aggregate_leaf.launches = 0


def aggregate_numerator(c, ww):
    """c [N, L, ...]; ww [N, L] fp32 -> [L, ...] fp32: ``sum_n ww c``."""
    N, Lk = c.shape[:2]
    F = math.prod(c.shape[2:])
    if c.device.type == "cpu":
        return R.numerator(c.reshape(N, Lk, F), ww).reshape(c.shape[1:])
    _check_args("aggregate_numerator", c, ww)
    out = torch.empty(c.shape[1:], dtype=torch.float32, device=c.device)
    if F == 0 or Lk == 0:
        return out
    rc = _kernel("repro_aggregate_numerator")(
        _DTYPE_CODE[c.dtype], c.data_ptr(), ww.data_ptr(), out.data_ptr(), N,
        Lk, F, torch.cuda.current_stream(c.device).cuda_stream)
    B.check(rc, "aggregate_numerator")
    aggregate_numerator.launches += 1
    return out


aggregate_numerator.launches = 0
