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


def ssd_chunks_at_once(x, dt, A, B, C, *, chunk: int = DEFAULT_CHUNK):
    """``ssd_chunked`` from a zero state, with every chunk at once: the
    same terms in a fixed number of batched operations, where the loop
    issues a dozen a chunk (under autograd, at 4,096 rows, the host's
    launches then pace the card). The state entering chunk c is
    Σ_{k<c} exp(t_{c−1} − t_k)·h_k, with h_k chunk k's own contribution
    to the state at its end and t the running sum of the chunks' total
    exponents; both exponents are masked to −inf where a term does not
    exist before ``exp``, as in ``ssd_chunked``. Arguments as there; a
    sequence that ``chunk`` does not divide is one chunk. Returns y
    [Bt, S, nh, hd] and the final state h [Bt, nh, hd, st], as
    ``ssd_chunked`` does."""
    Bt, S, nh, hd = x.shape
    st = B.shape[-1]
    if S % chunk != 0:
        chunk = S
    nc = S // chunk
    x, dt = x.reshape(Bt, nc, chunk, nh, hd), dt.reshape(Bt, nc, chunk, nh)
    B, C = B.reshape(Bt, nc, chunk, st), C.reshape(Bt, nc, chunk, st)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[:, :, None]
    s = torch.cumsum(dt * A, dim=2)                          # [Bt,nc,cl,nh]
    u = x * dt[..., None]                                    # [Bt,nc,cl,nh,hd]
    Lm = torch.exp(torch.where(tri, s[:, :, :, None] - s[:, :, None],
                               -torch.inf))                  # [Bt,nc,i,j,nh]
    W = torch.einsum("bcis,bcjs->bcij", C, B)[..., None] * Lm
    y = torch.einsum("bcijh,bcjhd->bcihd", W, u)             # intra-chunk
    decay_end = torch.exp(s[:, :, -1:] - s)                  # [Bt,nc,cl,nh]
    h_own = torch.einsum("bcjhd,bcjs->bchds", u * decay_end[..., None], B)
    t = torch.cumsum(s[:, :, -1], dim=1)                     # [Bt,nc,nh]
    t_prev = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
    earlier = torch.tril(torch.ones((nc, nc), dtype=torch.bool,
                                    device=x.device), -1)[:, :, None]
    carry = torch.exp(torch.where(earlier, t_prev[:, :, None] - t[:, None],
                                  -torch.inf))               # [Bt,c,k,nh]
    h_in = torch.einsum("bckh,bkhds->bchds", carry, h_own)
    y = y + torch.einsum("bcis,bchds->bcihd", C, h_in) \
        * torch.exp(s)[..., None]
    h = torch.exp(s[:, -1, -1])[:, :, None, None] * h_in[:, -1] \
        + h_own[:, -1]
    return y.reshape(Bt, S, nh, hd), h


def ssd_ref(x, dt, A, B, C, D=None, *, chunk: int = 128):
    """The kernel's function: ``ssd_chunked`` plus ``D·x`` (D [nh] or
    None). Returns (y, h_final)."""
    y, h = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y, h
