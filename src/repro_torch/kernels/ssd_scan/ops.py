"""The Mamba-2 SSD chunked scan: the ``ssd_scan`` CUDA kernel
(``csrc/ssd_scan.cu``) behind a checked wrapper.

``ssd_scan`` takes the plain version (``ref.ssd_ref``, at the kernel's
own chunk of ``KERNEL_CHUNK`` rows) for tensors that lie on the CPU, and
only then; for CUDA tensors it launches the kernel or raises.
``ssd_scan.launches`` counts wrapper calls that launched the kernel (its
pre-pass and the scan, one launch). The reference kernel has no
gradient (``jax.grad`` through it fails inside Pallas), so neither has
this one: the wrapper raises for an input that requires grad while grad
mode is on, on every device, rather than return a result that would
silently get no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref as R

KERNEL_CHUNK = 16     # the kernel's rows per chunk (csrc/ssd_scan.cu)
SIZES = ((8, 4), (32, 8), (32, 16), (32, 128), (64, 16), (64, 32),
         (64, 128))   # the (head_dim, state) pairs the kernel is built for


def _kernel():
    fn = build.load("ssd_scan").repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, A, B, C, D=None):
    """x [Bt,S,nh,hd]; dt [Bt,S,nh] (post-softplus); A [nh] (negative);
    B, C [Bt,S,st]; D [nh] or None. Returns (y [Bt,S,nh,hd], h_final
    [Bt,nh,hd,st]), y with ``D·x`` added; the state starts at zero."""
    ins = (x, dt, A, B, C) + (() if D is None else (D,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "ssd_scan: the kernel has no backward (nor has the "
            "reference's); call it under torch.no_grad(), or run the plain "
            "scan with use_pallas=False")
    if x.device.type == "cpu":
        return R.ssd_ref(x, dt, A, B, C, D, chunk=KERNEL_CHUNK)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or \
            B.shape != C.shape:
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B "
            f"{tuple(B.shape)} and C {tuple(C.shape)} must be [Bt, S, nh, "
            "hd], [Bt, S, nh] and [Bt, S, st]")
    Bt, S, nh, hd = x.shape
    st = B.shape[-1]
    if tuple(dt.shape) != (Bt, S, nh) or tuple(B.shape[:2]) != (Bt, S) \
            or tuple(A.shape) != (nh,) or \
            (D is not None and tuple(D.shape) != (nh,)):
        raise ValueError(
            f"ssd_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
            f"{tuple(B.shape)} and D {None if D is None else tuple(D.shape)}"
            f" do not fit x {tuple(x.shape)}")
    if (hd, st) not in SIZES:
        raise ValueError(f"ssd_scan: (head_dim, state) = {(hd, st)} not in "
                         f"{SIZES}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("ssd_scan: every input must be float32, got "
                        f"{[str(t.dtype) for t in ins]}")
    if not all(t.device == x.device for t in ins):
        raise ValueError("ssd_scan: every input must be on one device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, C)):
        raise ValueError("ssd_scan: x and C must be 16-byte aligned (the "
                         "kernel copies 16-byte vectors)")
    if Bt > 65535:
        raise ValueError(f"ssd_scan: batch {Bt} > 65535")
    y = torch.empty_like(x)
    h = torch.empty((Bt, nh, hd, st), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, h.zero_()
    # per (batch, chunk), written by the kernel's pre-pass: C·Bᵀ, and Bᵀ
    # split for the tensor cores (csrc/ssd_scan.cu)
    record = KERNEL_CHUNK * KERNEL_CHUNK + 2 * KERNEL_CHUNK * max(st, 8)
    cb = torch.empty((Bt, -(-S // KERNEL_CHUNK), record),
                     dtype=torch.float32, device=x.device)
    rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                   B.data_ptr(), C.data_ptr(),
                   None if D is None else D.data_ptr(), cb.data_ptr(),
                   y.data_ptr(), h.data_ptr(), Bt, S, nh, hd, st,
                   torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
