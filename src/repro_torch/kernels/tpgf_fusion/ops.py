"""TPGF fusion on tensors and trees: the ``fuse`` CUDA kernel
(``csrc/tpgf_fusion.cu``) behind a checked wrapper.

``fuse_leaf`` takes the plain version (``ref.fuse``) for a tensor that
lies on the CPU, and only then; for a CUDA tensor it launches the kernel
or raises. ``fuse_leaf.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.tpgf_fusion import ref as R
from repro_torch.tree import tree_map

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = B.load("tpgf_fusion").repro_fuse
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _weight_on(w_client, device) -> torch.Tensor:
    """The fusion weight as a one-element fp32 tensor on ``device`` (the
    kernel reads it through a pointer — no host sync)."""
    if not isinstance(w_client, torch.Tensor):
        return torch.full((), float(w_client), dtype=torch.float32,
                          device=device)
    if w_client.numel() != 1:
        raise ValueError(f"fuse: w_client must be a scalar, got shape "
                         f"{tuple(w_client.shape)}")
    if w_client.device != device:
        raise ValueError(f"fuse: w_client on {w_client.device}, gradients "
                         f"on {device}")
    return w_client.to(torch.float32).contiguous()


def fuse_leaf(a, b, w_client, clip_scale: float = 1.0):
    """``w·(a·cs) + (1−w)·b`` in fp32, returned in ``a``'s dtype."""
    if a.device.type == "cpu":
        return R.fuse(a, b, w_client, clip_scale)
    if a.device.type != "cuda":
        raise ValueError(f"fuse: no kernel for device {a.device}")
    if b.device != a.device or b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(
            f"fuse: a {tuple(a.shape)} {a.dtype} on {a.device} and b "
            f"{tuple(b.shape)} {b.dtype} on {b.device} must match")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"fuse: dtype {a.dtype} not supported "
                        f"(float32, bfloat16)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fuse: a and b must be contiguous")
    w = _weight_on(w_client, a.device)
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    rc = _kernel()(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), w.data_ptr(), float(clip_scale), n,
                   torch.cuda.current_stream(a.device).cuda_stream)
    B.check(rc, "fuse")
    fuse_leaf.launches += 1
    return out


fuse_leaf.launches = 0


def fuse_tree(g_client, g_server, w_client, *, tau: float = None):
    """Eq. 4 over a tree, leaf by leaf, at clip scale 1.0 (the path's
    call: the Phase-1 clip is applied before)."""
    if tau is not None:
        raise NotImplementedError(
            "fuse_tree(tau=): the fused clip needs the sumsq_2d kernel "
            "(ROADMAP queue 2, item 2)")
    return tree_map(lambda a, b: fuse_leaf(a, b, w_client, 1.0),
                    g_client, g_server)
