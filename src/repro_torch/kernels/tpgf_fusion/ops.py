"""TPGF fusion on tensors and trees: the ``fuse``, ``tier_sum`` and
``sumsq`` CUDA kernels (``csrc/tpgf_fusion.cu``) behind checked wrappers.

Each wrapper takes its plain version (``ref.py``) for a tensor that lies
on the CPU, and only then; for a CUDA tensor it launches the kernel or
raises. ``fuse_leaf.launches``, ``tier_sum_leaf.launches`` and
``sumsq_leaf.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.tpgf_fusion import ref as R
from repro_torch.tree import tree_leaves, tree_map

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_TIERS = 8            # tier pointers travel by value in a fixed struct
SUMSQ_MAX_BLOCKS = 1024  # sumsq's pass-1 grid, and its partials scratch

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "repro_fuse": [_I, _P, _P, _P, _P, _P, _I64, _P],
    "repro_tier_sum": [_I, ctypes.POINTER(_P), _P, _P, _I64, _P],
    "repro_sumsq": [_I, _P, _I64, _P, _I, _P, _P],
}


def _kernel(name: str):
    fn = getattr(B.load("tpgf_fusion"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _scalar_on(x, device, what: str) -> torch.Tensor:
    """``x`` as a one-element fp32 tensor on ``device`` (the kernels read
    their scalars through a pointer — no host sync)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    if x.numel() != 1:
        raise ValueError(f"{what} must be a scalar, got shape "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{what} on {x.device}, tensors on {device}")
    return x.to(torch.float32).contiguous()


def fuse_leaf(a, b, w_client, clip_scale=1.0):
    """``w·(a·cs) + (1−w)·b`` in fp32, returned in ``a``'s dtype; ``w`` and
    ``cs`` are floats or one-element tensors."""
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
    w = _scalar_on(w_client, a.device, "fuse: w_client")
    cs = _scalar_on(clip_scale, a.device, "fuse: clip_scale")
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    rc = _kernel("repro_fuse")(_DTYPE_CODE[a.dtype], a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), w.data_ptr(),
                               cs.data_ptr(), n, _stream(a.device))
    B.check(rc, "fuse")
    fuse_leaf.launches += 1
    return out


fuse_leaf.launches = 0


def tier_sum_leaf(leaves, weights):
    """``sum_t weights[t] * leaves[t]`` for same-shape fp32 leaves, one per
    tier in canonical order; ``weights`` are fp32 scalars (a list of
    one-element tensors, or one ``[T]`` tensor). Returns fp32."""
    leaves = list(leaves)
    x0 = leaves[0]
    if x0.device.type == "cpu":
        return R.tier_sum(leaves, weights)
    if x0.device.type != "cuda":
        raise ValueError(f"tier_sum: no kernel for device {x0.device}")
    T = len(leaves)
    if T > MAX_TIERS:
        raise ValueError(f"tier_sum: at most {MAX_TIERS} tiers, got {T}")
    for x in leaves:
        if x.device != x0.device or x.shape != x0.shape:
            raise ValueError(
                f"tier_sum: leaves {tuple(x.shape)} on {x.device} and "
                f"{tuple(x0.shape)} on {x0.device} must match")
        if x.dtype != torch.float32:
            raise TypeError(f"tier_sum: leaves must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError("tier_sum: leaves must be contiguous")
    if isinstance(weights, torch.Tensor):
        w = weights
    else:
        w = torch.stack([_scalar_on(wt, x0.device, "tier_sum: weight")
                         for wt in weights])
    if w.numel() != T or w.device != x0.device:
        raise ValueError(f"tier_sum: {T} weights on {x0.device} expected, "
                         f"got shape {tuple(w.shape)} on {w.device}")
    w = w.to(torch.float32).reshape(T).contiguous()
    out = torch.empty(x0.shape, dtype=torch.float32, device=x0.device)
    n = x0.numel()
    if n == 0:
        return out
    ptrs = (_P * T)(*[x.data_ptr() for x in leaves])
    rc = _kernel("repro_tier_sum")(T, ptrs, w.data_ptr(), out.data_ptr(), n,
                                   _stream(x0.device))
    B.check(rc, "tier_sum")
    tier_sum_leaf.launches += 1
    return out


tier_sum_leaf.launches = 0


def sumsq_leaf(x, total=None):
    """Add ``sum x^2`` (fp32) into the one-element fp32 tensor ``total``
    in place and return it; a new zero total when ``total`` is None."""
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return total.add_(R.sumsq(x))
    if x.device.type != "cuda":
        raise ValueError(f"sumsq: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"sumsq: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("sumsq: x must be contiguous")
    if total.device != x.device or total.dtype != torch.float32 \
            or total.numel() != 1 or not total.is_contiguous():
        raise ValueError("sumsq: total must be one contiguous float32 value "
                         f"on {x.device}")
    n = x.numel()
    if n == 0:
        return total
    partials = torch.empty(SUMSQ_MAX_BLOCKS, dtype=torch.float32,
                           device=x.device)
    rc = _kernel("repro_sumsq")(_DTYPE_CODE[x.dtype], x.data_ptr(), n,
                                partials.data_ptr(), SUMSQ_MAX_BLOCKS,
                                total.data_ptr(), _stream(x.device))
    B.check(rc, "sumsq")
    sumsq_leaf.launches += 1
    return total


sumsq_leaf.launches = 0


def fuse_tree(g_client, g_server, w_client, *, tau: float = None):
    """Eq. 4 over a tree, leaf by leaf. With ``tau`` the Phase-1 global-L2
    clip is fused in: Σx² over ``g_client``'s leaves in leaf order (the
    ``sumsq`` kernel), clip scale ``min(1, tau/(sqrt(Σ) + 1e-12))``, all on
    the device (Phase 3 on the card, ``core.tpgf.clip_and_fuse``); without
    it the clip scale is 1.0 (``fuse_gradients``: the clip is applied
    before)."""
    leaves = tree_leaves(g_client)
    dev = leaves[0].device
    if tau is None:
        cs = torch.ones((), dtype=torch.float32, device=dev)
    else:
        if tau < 0:
            raise ValueError(f"fuse_tree: tau must be >= 0, got {tau}")
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for leaf in leaves:
            sumsq_leaf(leaf, total)
        cs = torch.clamp(tau / (torch.sqrt(total) + 1e-12), max=1.0)
    return tree_map(lambda a, b: fuse_leaf(a, b, w_client, cs),
                    g_client, g_server)
