"""Plain PyTorch version of the SSD-scan kernel: the chunked Mamba-2 scan
of the JAX package's ``models/ssm.py::ssd_chunked``, op for op.

Per chunk of ``chunk`` rows, with the state h carried across chunks:

    s = cumsum(dt·A)                       u = x·dt
    W = tril(C Bᵀ ∘ exp(sᵢ − sⱼ))          (the exponent masked to −inf
                                            above the diagonal first)
    y = W u + exp(s)·(C hᵀ)
    h ← exp(s_last)·h + Σⱼ exp(s_last − sⱼ)·uⱼ ⊗ Bⱼ

A sequence that ``chunk`` does not divide is taken as ONE chunk of S
rows, as the reference does.

The reference takes ``exp`` of the whole [cl, cl] matrix of sᵢ − sⱼ and
masks the product afterwards; above the diagonal sᵢ − sⱼ > 0 grows with
the chunk and overflows to inf once Σ dt·|A| over a chunk passes ~88
(Mamba2-2.7B at full width does). The forward never sees it, but the
backward sends 0 · inf = NaN into dt, A, B and C. Here the exponent is
masked to −inf above the diagonal before ``exp``: the forward is the
same bit for bit, and the gradient is the reference's wherever that one
is finite (departure (f) in ROADMAP.md).
"""
from __future__ import annotations

import torch

DEFAULT_CHUNK = 256


def ssd_chunked(x, dt, A, B, C, *, chunk: int = DEFAULT_CHUNK, h0=None):
    """x [Bt, S, nh, hd] (not yet scaled by dt); dt [Bt, S, nh]
    (post-softplus); A [nh] (negative); B, C [Bt, S, st]; h0 optional
    [Bt, nh, hd, st]. Returns y [Bt, S, nh, hd], h_final [Bt, nh, hd, st].
    """
    Bt, S, nh, hd = x.shape
    st = B.shape[-1]
    if S % chunk != 0:
        chunk = S  # one chunk for a sequence the chunk does not divide
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = (torch.zeros((Bt, nh, hd, st), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, S, chunk):
        xk, dtk = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bk, Ck = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        s = torch.cumsum(dtk * A, dim=1)                     # [Bt,cl,nh]
        u = xk * dtk[..., None]                              # [Bt,cl,nh,hd]
        CB = torch.einsum("bis,bjs->bij", Ck, Bk)            # [Bt,cl,cl]
        lower = tri[None, :, :, None]
        Lm = torch.exp(torch.where(lower, s[:, :, None, :] - s[:, None, :, :],
                                   -torch.inf))              # [Bt,i,j,nh]
        W = torch.where(lower, CB[..., None] * Lm, 0.0)
        y = torch.einsum("bijh,bjhd->bihd", W, u)            # intra-chunk
        y = y + torch.einsum("bis,bih,bhds->bihd", Ck, torch.exp(s), h)
        decay_end = torch.exp(s[:, -1:, :] - s)              # [Bt,cl,nh]
        h_chunk = torch.einsum("bjh,bjs,bjhd->bhds", decay_end, Bk, u)
        h = h * torch.exp(s[:, -1, :])[:, :, None, None] + h_chunk
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else torch.zeros_like(x)
    return y, h


def ssd_ref(x, dt, A, B, C, D=None, *, chunk: int = 128):
    """The kernel's function: ``ssd_chunked`` plus ``D·x`` (D [nh] or
    None). Returns (y, h_final)."""
    y, h = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y, h
