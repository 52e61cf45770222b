"""Causal / sliding-window GQA attention: the ``flash_attention`` CUDA
kernel (``csrc/flash_attention.cu``) behind a checked wrapper.

``flash_attention`` takes the plain version (``ref.flash_attention_ref``)
for tensors that lie on the CPU, and only then; for CUDA tensors it
launches the kernel or raises. ``flash_attention.launches`` counts kernel
launches. The reference kernel has no gradient, so neither has this one:
the wrapper raises for a CUDA input that requires grad while grad mode is
on, rather than return a result that would silently get no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import ref as R

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _kernel():
    fn = B.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,hd]; k,v [B,Skv,K,hd] (H % K == 0) -> [B,Sq,H,hd] in
    q's dtype."""
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} must be [B, Sq, H, hd] and [B, Skv, K, hd]")
    Bt, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape[0] != Bt or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need one batch and head_dim, and H % K == 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype} and v "
                        f"{v.dtype} must share one dtype of float32, "
                        "bfloat16")
    if not all(t.device == q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k and v must be "
                         "16-byte aligned (the kernel reads them by TMA)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward (nor has the "
            "reference's); call it under torch.no_grad(), or run the plain "
            "attention with use_pallas=False")
    if window < 0 or Skv == 0 or Bt > 65535 or H > 65535 or \
            Sq > 65535 * 64:
        raise ValueError(f"flash_attention: window {window} must be >= 0, "
                         f"Skv {Skv} >= 1, B {Bt} and H {H} <= 65535, Sq "
                         f"{Sq} <= {65535 * 64}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), Bt, Sq, Skv, H, K, hd,
                   int(bool(causal)), int(window),
                   torch.cuda.current_stream(q.device).cuda_stream)
    B.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
