"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import). Run them on a machine with
one card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 1e-6 relative for ``fuse`` (it rounds each product on
its own, as the plain formula does) and 1e-5 for ``aggregate`` (it sums
clients in order, the plain version's einsum in another order); bf16 2e-2.
``tier_sum`` is bit-exact (it adds in the plain version's order);
``sumsq`` within 1e-5 relative (another summation order) and the same
bits on two calls. ``flash_attention`` within the reference kernel's own
test tolerances, 2e-5 (fp32) and 3e-2 (bf16), at ``chip_smoke.py``'s
shapes: the serve path's and Hymba's (H and K not powers of two), a
window (also one across tile edges), MQA, every head dim, S one row past
a tile, Sq = 1, Sq and Skv unequal, and non-causal cases. ``ssd_scan``
within 1e-4 of the largest magnitude of y and of h (the reference
kernel's own bar; its chunk differs from the plain version's, so the
sums run in other orders) at ``chip_smoke.py``'s shapes: the Mamba2 and
Hymba serve shapes, ``test_kernels.py``'s, every (head_dim, state) pair,
S not a multiple of the kernel's chunk, S = 1, an odd number of heads, no
D, and dt near 1 with A = −16, where an unmasked upper half would
overflow. One round of the scenario strategies ``unstable`` and ``hasfl``
(width ladder, fused) launches the kernels of its path and agrees with the
same round with the kernels off within 1e-4. ``flash_attention`` at
Mixtral-8x7B's windowed prefill shape (S 8,192, window 4,096), and a
reduced Mixtral prefill past its window: one launch a layer, kernels on
vs off within 1e-4, the rolled cache. ``flash_attention`` at
Whisper-small's decoder shape (16 × 224, 12 heads of 64), and a
full-size fp32 Whisper prefill: one launch in each decoder layer,
kernels on vs off within 1e-3 of the largest logit, the cross-attention
cache bit for bit. ``flash_attention``, ``ssd_scan`` and ``fuse`` through
the sharded regions' ``local_map`` on a (1, 1) NCCL mesh: the launches
and the results of the meshless run; a gloo mesh of CUDA tensors
refused. TPGF's Phase 3 in reduced bf16 Mixtral and Granite steps with
the kernels off: ``sumsq`` and ``fuse`` once per client leaf and
microbatch, within the plain chain's extra rounding
(``ref.plain_chain_bound``) of it.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(7,), (33, 65), (4, 7, 13), (3, 48, 96)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_fuse_kernel_matches_plain(cuda, shape, dtype, tol):
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.tensor(0.3, device=cuda)
    before = O.fuse_leaf.launches
    got = O.fuse_leaf(a, b, w, 0.7)
    torch.cuda.synchronize()
    assert O.fuse_leaf.launches == before + 1
    torch.testing.assert_close(got.float(), R.fuse(a, b, w, 0.7).float(),
                               rtol=tol, atol=tol)


def test_fuse_kernel_reads_a_device_clip_scale(cuda):
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((5, 131), generator=g, device=cuda)
    b = torch.randn((5, 131), generator=g, device=cuda)
    w = torch.tensor(0.6, device=cuda)
    cs = torch.tensor(0.25, device=cuda)
    got = O.fuse_leaf(a, b, w, cs)
    torch.testing.assert_close(got, R.fuse(a, b, w, cs), rtol=0, atol=0)
    with pytest.raises(ValueError):
        O.fuse_leaf(a, b, w, torch.ones(2, device=cuda))


@pytest.mark.parametrize("T,shape", [(1, (7,)), (2, (1000,)),
                                     (3, (33, 65)), (4, (256, 128)),
                                     (8, (3, 48, 96))])
def test_tier_sum_kernel_matches_plain_bit_for_bit(cuda, T, shape):
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(3)
    leaves = [torch.randn(shape, generator=g, device=cuda) for _ in range(T)]
    w = torch.rand(T, generator=g, device=cuda) * 2
    w[-1] = 0.0
    before = O.tier_sum_leaf.launches
    got = O.tier_sum_leaf(leaves, w)
    torch.cuda.synchronize()
    assert O.tier_sum_leaf.launches == before + 1
    assert torch.equal(got, R.tier_sum(leaves, list(w)))
    # an unaligned leaf (offset by one element) takes the scalar loop
    flat = torch.randn(leaves[0].numel() + 1, generator=g, device=cuda)
    odd = [flat[1:].view(shape)] + leaves[1:]
    assert torch.equal(O.tier_sum_leaf(odd, w), R.tier_sum(odd, list(w)))


def test_tier_sum_kernel_checks_its_inputs(cuda):
    from repro_torch.kernels.tpgf_fusion import ops as O
    x = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError):
        O.tier_sum_leaf([x] * 9, torch.ones(9, device=cuda))
    with pytest.raises(ValueError):
        O.tier_sum_leaf([x, torch.zeros((4, 5), device=cuda)],
                        torch.ones(2, device=cuda))
    with pytest.raises(TypeError):
        O.tier_sum_leaf([x.bfloat16()], torch.ones(1, device=cuda))
    with pytest.raises(ValueError):
        O.tier_sum_leaf([x.t()], torch.ones(1, device=cuda))


@pytest.mark.parametrize("shape", [(7,), (1000,), (33, 65), (10, 768, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sumsq_kernel_matches_plain_and_is_deterministic(cuda, shape, dtype):
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = O.sumsq_leaf.launches
    a = O.sumsq_leaf(x)
    b = O.sumsq_leaf(x)
    torch.cuda.synchronize()
    assert O.sumsq_leaf.launches == before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, R.sumsq(x), rtol=1e-5, atol=0)


def test_fuse_tree_with_tau_matches_clip_and_fuse(cuda):
    from repro_torch.core import tpgf as T
    from repro_torch.kernels.tpgf_fusion import ops as O
    g = torch.Generator(device=cuda).manual_seed(5)
    gc = {"a": torch.randn((17, 9), generator=g, device=cuda),
          "b": {"c": torch.randn((3, 48, 96), generator=g, device=cuda)}}
    gs = {"a": torch.randn((17, 9), generator=g, device=cuda),
          "b": {"c": torch.randn((3, 48, 96), generator=g, device=cuda)}}
    w = torch.tensor(0.4, device=cuda)
    got = O.fuse_tree(gc, gs, w, tau=0.5)
    clipped, _ = T.clip_by_global_l2(gc, 0.5)
    want = T.fuse_gradients(clipped, gs, w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_fuse_kernel_checks_its_inputs(cuda):
    from repro_torch.kernels.tpgf_fusion import ops as O
    a = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError):
        O.fuse_leaf(a, torch.zeros((4, 5), device=cuda), 0.5)
    with pytest.raises(ValueError):
        O.fuse_leaf(a.t(), a, 0.5)
    with pytest.raises(TypeError):
        O.fuse_leaf(a.double(), a.double(), 0.5)


@pytest.mark.parametrize("N,Lk,rest", [(3, 2, (40,)), (5, 4, (3, 90)),
                                       (8, 12, (48, 96))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_aggregate_kernel_matches_plain(cuda, N, Lk, rest, dtype, tol):
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(1)
    c = torch.randn((N, Lk) + rest, generator=g, device=cuda).to(dtype)
    s = torch.randn((Lk,) + rest, generator=g, device=cuda).to(dtype)
    ww = torch.rand((N, Lk), generator=g, device=cuda)
    ww[0, Lk // 2:] = 0.0
    before = O.aggregate_leaf.launches
    got = O.aggregate_leaf(c, ww, s, 0.01)
    torch.cuda.synchronize()
    assert O.aggregate_leaf.launches == before + 1
    F = c[0, 0].numel()
    want = R.aggregate(c.reshape(N, Lk, F), ww, s.reshape(Lk, F),
                       0.01).reshape(s.shape)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 0.1)


@pytest.mark.parametrize("N,Lk,rest", [(3, 2, (40,)), (4, 12, (48, 96)),
                                       (0, 3, (17,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_numerator_mode_matches_plain(cuda, N, Lk, rest, dtype):
    """The numerator mode a fleet mesh's ranks run on their own rows:
    fp32 sum_n ww c (a rank may own no client: zeros), within the full
    mode's 1e-5 of the plain version."""
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(2)
    c = torch.randn((N, Lk) + rest, generator=g, device=cuda).to(dtype)
    ww = torch.rand((N, Lk), generator=g, device=cuda)
    before = O.aggregate_numerator.launches
    got = O.aggregate_numerator(c, ww)
    torch.cuda.synchronize()
    assert O.aggregate_numerator.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == c.shape[1:]
    F = c[0, 0].numel() if N else math.prod(rest)
    want = R.numerator(c.reshape(N, Lk, F), ww).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_aggregate_kernel_all_zero_weights(cuda):
    from repro_torch.kernels.layer_aggregate import ops as O
    c = torch.randn((3, 2, 130), device=cuda)
    s = torch.randn((2, 130), device=cuda)
    got = O.aggregate_leaf(c, torch.zeros((3, 2), device=cuda), s, 0.01)
    ulp = torch.nextafter(s.abs(), torch.full_like(s, float("inf"))) \
        - s.abs()
    assert bool(torch.all((got - s).abs() <= ulp))


def test_aggregate_kernel_at_splitfeds_presence_pattern(cuda):
    """SplitFed puts every client at d = L/2: rows >= d carry only the
    server term lam*s and must come back as the server row (within one
    ulp, as with all-zero weights); rows < d agree with the plain
    version."""
    from repro_torch.kernels.layer_aggregate import ops as O, ref as R
    N, Lk, rest = 8, 12, (48, 96)
    d = Lk // 2
    g = torch.Generator(device=cuda).manual_seed(5)
    c = torch.randn((N, Lk) + rest, generator=g, device=cuda)
    c[:, d:] = 0.0                      # the workspace zeroes rows >= d
    s = torch.randn((Lk,) + rest, generator=g, device=cuda)
    w = torch.full((N,), 1.0 / N, device=cuda)
    pres = (torch.arange(Lk, device=cuda) < d).float()
    ww = (w[:, None] * pres[None, :]).contiguous()
    got = O.aggregate_leaf(c, ww, s, 0.01)
    F = c[0, 0].numel()
    want = R.aggregate(c.reshape(N, Lk, F), ww, s.reshape(Lk, F),
                       0.01).reshape(s.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    top = s[d:]
    ulp = torch.nextafter(top.abs(), torch.full_like(top, float("inf"))) \
        - top.abs()
    assert bool(torch.all((got[d:] - top).abs() <= ulp))


# the chip smoke's flash_attention cases: (B, S, H, K, hd, causal, window)
FLASH_CASES = [
    (4, 2048, 24, 8, 128, True, 0),      # the serve path's shape
    (1, 1024, 8, 2, 128, True, 256),     # sliding window
    (2, 512, 8, 1, 64, True, 0),         # MQA
    (1, 256, 4, 2, 32, True, 0),
    (1, 256, 4, 2, 64, True, 0),
    (1, 256, 4, 2, 256, True, 0),
    (2, 1000, 4, 2, 128, True, 0),       # ragged: not a multiple of 64
    (1, 300, 4, 4, 64, False, 0),        # non-causal, ragged
    (1, 300, 4, 4, 64, False, 100),      # non-causal window
    (4, 2048, 25, 5, 64, True, 0),       # Hymba's: H and K not powers of 2
    (2, 129, 4, 2, 128, True, 0),        # one row past a q and a kv tile
    (1, 300, 4, 4, 64, True, 100),       # a window across tile edges
    (2, 1, 4, 2, 64, True, 0),           # Sq = Skv = 1
]

# (B, Sq, Skv, H, K, hd, causal, window): queries and keys of other
# lengths, neither a multiple of a tile
FLASH_RAGGED_CASES = [
    (2, 1000, 129, 4, 2, 128, True, 0),
    (2, 129, 1000, 4, 2, 128, True, 0),
    (2, 1000, 129, 8, 2, 64, False, 0),
    (2, 1, 300, 4, 2, 256, False, 0),    # Sq = 1
    (1, 1, 300, 4, 4, 32, True, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol):
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    B, S, H, K, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device=cuda).to(dtype)
    before = O.flash_attention.launches
    got = O.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert O.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FLASH_RAGGED_CASES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_matches_plain_sq_ne_skv(cuda, case, dtype,
                                                        tol):
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    B, Sq, Skv, H, K, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, K, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, K, hd), generator=g, device=cuda).to(dtype)
    got = O.flash_attention(q, k, v, causal=causal, window=window)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_checks_its_inputs(cuda):
    from repro_torch.kernels.flash_attention import ops as O
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    kv = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError):                   # H % K != 0
        O.flash_attention(q, torch.zeros((1, 8, 3, 64), device=cuda),
                          torch.zeros((1, 8, 3, 64), device=cuda))
    with pytest.raises(ValueError):                   # head_dim 48
        x = torch.zeros((1, 8, 2, 48), device=cuda)
        O.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        O.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):
        O.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                          kv, kv)
    flat = torch.zeros(8 * 4 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):      # offset 2 bytes
        O.flash_attention(flat[1:].view(1, 8, 4, 64), kv.bfloat16(),
                          kv.bfloat16())


def test_flash_attention_kernel_refuses_grad(cuda):
    from repro_torch.kernels.flash_attention import ops as O
    q = torch.randn((1, 64, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=cuda)
    before = O.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        O.flash_attention(q, kv, kv)
    assert O.flash_attention.launches == before
    with torch.no_grad():
        O.flash_attention(q, kv, kv)
    assert O.flash_attention.launches == before + 1


# the chip smoke's ssd_scan cases: (Bt, S, nh, hd, st, the plain
# version's chunk: one that divides S)
SSD_CASES = [
    (4, 2048, 80, 64, 128, 256),         # Mamba2-2.7B serve shape
    (4, 2048, 50, 64, 16, 256),          # Hymba-1.5B serve shape
    (2, 256, 4, 32, 16, 128),            # test_kernels.py's four
    (1, 128, 2, 64, 32, 64),
    (2, 64, 3, 32, 16, 64),
    (1, 512, 2, 32, 128, 128),
    (1, 32, 2, 8, 4, 16),                # the recurrence test's
    (2, 96, 4, 32, 8, 96),               # Hymba reduced (hd 32, st 8)
    (4, 2000, 80, 64, 128, 250),         # ragged: 2000 = 62·32 + 16
    (2, 77, 4, 32, 16, 77),              # ragged, one plain chunk
    (3, 1, 2, 64, 128, 1),               # one row
    (2, 999, 6, 64, 128, 333),           # S not a multiple of the chunk
    (1, 1, 50, 64, 16, 1),               # S = 1 at Hymba's heads
    (2, 256, 7, 32, 16, 128),            # an odd number of heads
]


def _ssd_inputs(cuda, Bt, S, nh, hd, st, seed, *, dt_range=(0.01, 0.2),
                A=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((Bt, S, nh, hd), generator=g, device=cuda)
    lo, hi = dt_range
    dt = lo + (hi - lo) * torch.rand((Bt, S, nh), generator=g, device=cuda)
    if A is None:    # the model's A = −exp(log(linspace(1, 16)))
        A = -torch.linspace(1.0, 16.0, nh, device=cuda)
    B = torch.randn((Bt, S, st), generator=g, device=cuda)
    C = torch.randn((Bt, S, st), generator=g, device=cuda)
    D = torch.randn((nh,), generator=g, device=cuda)
    return x, dt, A, B, C, D


def _close_to_largest(got, want, tol=1e-4):
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.ssd_scan import ops as O, ref as R
    Bt, S, nh, hd, st, chunk = case
    x, dt, A, B, C, D = _ssd_inputs(cuda, Bt, S, nh, hd, st, 7)
    before = O.ssd_scan.launches
    y, h = O.ssd_scan(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert O.ssd_scan.launches == before + 1
    assert y.shape == x.shape and h.shape == (Bt, nh, hd, st)
    want_y, want_h = R.ssd_ref(x, dt, A, B, C, D, chunk=chunk)
    _close_to_largest(y, want_y)
    _close_to_largest(h, want_h)


def test_ssd_scan_kernel_without_d_and_where_the_upper_half_overflows(cuda):
    from repro_torch.kernels.ssd_scan import ops as O, ref as R
    x, dt, A, B, C, _ = _ssd_inputs(cuda, 2, 256, 8, 64, 128, 8)
    y, h = O.ssd_scan(x, dt, A, B, C)                  # D = None
    want_y, want_h = R.ssd_ref(x, dt, A, B, C, chunk=128)
    _close_to_largest(y, want_y)
    _close_to_largest(h, want_h)
    x, dt, A, B, C, D = _ssd_inputs(
        cuda, 2, 256, 8, 64, 128, 9, dt_range=(0.5, 1.0),
        A=torch.full((8,), -16.0, device=cuda))
    y, h = O.ssd_scan(x, dt, A, B, C, D)
    want_y, want_h = R.ssd_ref(x, dt, A, B, C, D, chunk=256)
    _close_to_largest(y, want_y)
    _close_to_largest(h, want_h)


def test_ssd_scan_kernel_checks_its_inputs(cuda):
    from repro_torch.kernels.ssd_scan import ops as O
    x, dt, A, B, C, D = _ssd_inputs(cuda, 1, 16, 2, 32, 16, 10)
    b24 = torch.zeros((1, 16, 24), device=cuda)
    with pytest.raises(ValueError, match="not in"):   # (hd, st) = (32, 24)
        O.ssd_scan(x, dt, A, b24, b24, D)
    with pytest.raises(ValueError, match="not in"):   # head_dim 48
        O.ssd_scan(torch.zeros((1, 16, 2, 48), device=cuda), dt, A, B, C)
    with pytest.raises(ValueError):                   # B and C differ
        O.ssd_scan(x, dt, A, B, b24, D)
    with pytest.raises(TypeError):
        O.ssd_scan(x.double(), dt, A, B, C, D)
    strided = torch.zeros((1, 16, 32), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        O.ssd_scan(x, dt, A, B, strided, D)
    with pytest.raises(ValueError, match="fit"):      # A of the wrong size
        O.ssd_scan(x, dt, A[:1], B, C, D)


def test_ssd_scan_kernel_refuses_grad(cuda):
    from repro_torch.kernels.ssd_scan import ops as O
    x, dt, A, B, C, D = _ssd_inputs(cuda, 1, 64, 2, 64, 16, 11)
    x.requires_grad_(True)
    before = O.ssd_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        O.ssd_scan(x, dt, A, B, C, D)
    assert O.ssd_scan.launches == before
    with torch.no_grad():
        O.ssd_scan(x, dt, A, B, C, D)
    assert O.ssd_scan.launches == before + 1


def _mamba2_client_shapes():
    """The distinct leaf shapes of full-width Mamba2-2.7B's client view at
    its split depth (on the meta device)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.supernet import split_params
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves
    cfg = get_config("mamba2_2_7b")
    client = split_params(cfg, init_params(cfg, None, device="meta"),
                          cfg.resolved_split_depth)[0]
    return sorted({tuple(x.shape) for x in tree_leaves(client)})


@pytest.mark.parametrize("shape", _mamba2_client_shapes(), ids=str)
def test_fuse_kernel_bf16_at_mamba2_client_leaf_shapes(cuda, shape):
    """Eq. 4 on bf16 client gradients, as the LM training path calls it
    (w and the clip scale on the device): within one bf16 ulp of the
    plain version."""
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(12)
    a = torch.randn(shape, generator=g, device=cuda).bfloat16()
    b = torch.randn(shape, generator=g, device=cuda).bfloat16()
    w = torch.tensor(0.2477, device=cuda)
    one = torch.ones((), device=cuda)
    before = O.fuse_leaf.launches
    got = O.fuse_leaf(a, b, w, one)
    assert O.fuse_leaf.launches == before + 1 and got.dtype == torch.bfloat16
    want = R.fuse(a, b, w, one)

    def ordered(t):      # bf16 bits as integers in the values' order
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    assert int((ordered(got) - ordered(want)).abs().max()) <= 1


def test_ssm_train_step_on_the_card_launches_fuse_and_no_scan(cuda):
    """A training step of the reduced ssm config with ``use_pallas=True``:
    Eq. 4 runs the ``fuse`` kernel once per client leaf and microbatch;
    the scan records a gradient, so ``ssd_scan`` never launches."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.core.supernet import split_params
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves
    cfg = get_reduced("mamba2_2_7b").replace(use_pallas=True,
                                             microbatches=2)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    n_client = len(tree_leaves(split_params(
        cfg, params, cfg.resolved_split_depth)[0]))
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=g,
                              device=cuda) for k in ("tokens", "labels")}
    fuse0, scan0 = fuse_leaf.launches, ssd_scan.launches
    params, state, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    assert fuse_leaf.launches - fuse0 == 2 * n_client
    assert ssd_scan.launches == scan0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


PHASE3_ARCHS = ["mixtral_8x7b", "granite_4_0_h_small"]


def _bf16_train_case(cuda, arch, microbatches):
    """A reduced config in bf16 with the kernels off, its parameters on
    the card and a batch of 4 × 32 tokens."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models.model import init_params
    cfg = get_reduced(arch).replace(dtype="bfloat16", use_pallas=False,
                                    microbatches=microbatches)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 33), generator=g, device=cuda)
    return cfg, params, {"tokens": tok[:, :32], "labels": tok[:, 1:]}


@pytest.mark.parametrize("arch", PHASE3_ARCHS)
def test_train_step_on_the_card_runs_phase3_through_sumsq_and_fuse(cuda,
                                                                   arch):
    """A reduced moe (Mixtral) and ssm_moe (Granite) train step in bf16
    with ``use_pallas=False``: Phase 3 follows the gradients' device, so
    ``sumsq`` and ``fuse`` each launch once per non-empty client leaf and
    microbatch (an empty kind stack launches nothing), and the metrics are
    finite."""
    from repro_torch.core.supernet import split_params
    from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf, sumsq_leaf
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import tree_leaves
    cfg, params, batch = _bf16_train_case(cuda, arch, 2)
    n_client = sum(1 for x in tree_leaves(split_params(
        cfg, params, cfg.resolved_split_depth)[0]) if x.numel())
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    sumsq0, fuse0 = sumsq_leaf.launches, fuse_leaf.launches
    params, state, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    assert sumsq_leaf.launches - sumsq0 == 2 * n_client
    assert fuse_leaf.launches - fuse0 == 2 * n_client
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("arch", PHASE3_ARCHS)
def test_phase3_kernel_route_within_the_plain_chains_rounding(cuda, arch):
    """On one microbatch's client gradients as ``torch.autograd.grad``
    returns them on the card (every leaf contiguous): the kernel route
    (``fuse_tree(tau=)``), the clip engaged, is within one bf16 ulp of the
    fp32 Eq. 4 rounded once, give or take its clip scale's other order of
    summation, and in all no farther from it than the plain chain
    (``clip_by_global_l2``, then ``fuse_gradients``); the two lie within
    one ulp of the result plus ``w`` times one ulp of the clipped term
    (``ref.plain_chain_bound``).
    ``tpgf_grads_split`` returned the kernel route's result bit for
    bit."""
    from repro_torch.core import supernet as SN
    from repro_torch.core import tpgf as T
    from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
    from repro_torch.tree import tree_flatten_with_path
    cfg, params, batch = _bf16_train_case(cuda, arch, 1)
    d = cfg.resolved_split_depth
    calls, inner = [], T.clip_and_fuse

    def watched(*args, **kwargs):
        calls.append(args)
        return inner(*args, **kwargs)

    T.clip_and_fuse = watched
    try:
        out = T.tpgf_grads_split(cfg, cfg, *SN.split_params(cfg, params, d),
                                 batch, d)
    finally:
        T.clip_and_fuse = inner
    gl, gs, w, tau = calls[0]
    for path, x in tree_flatten_with_path(gl) + tree_flatten_with_path(gs):
        assert x.is_contiguous(), path
    again = O.fuse_tree(gl, gs, w.float(), tau=tau)
    norm = float(T.clip_by_global_l2(gl, tau)[1])
    tau = min(tau, 0.5 * norm)                         # the clip engaged
    got = O.fuse_tree(gl, gs, w.float(), tau=tau)
    clipped, norm = T.clip_by_global_l2(gl, tau)
    cs = torch.clamp(tau / (norm + 1e-12), max=1.0)
    want = T.fuse_gradients(clipped, gs, w)
    err_got = err_want = 0.0
    for (path, x), (_, y), (_, z), (_, f), (_, a), (_, b) in zip(
            tree_flatten_with_path(got), tree_flatten_with_path(want),
            tree_flatten_with_path(again),
            tree_flatten_with_path(out.g_client),
            tree_flatten_with_path(gl), tree_flatten_with_path(gs)):
        assert x.dtype == y.dtype == torch.bfloat16, path
        assert torch.equal(z, f), path
        exact = R.eq4_fp32(a, b, w, cs)
        # the kernels' clip scale sums Σx² in another order: a few fp32
        # ulps of cs, far below a bf16 ulp of the clipped term
        gap = (x.float() - exact.to(x.dtype).float()).abs()
        slack = 2.0 ** -16 * w.float() * (a.float() * cs).abs()
        assert bool((gap <= R.bf16_ulp(exact) + slack).all()), path
        err_got += float((x.float() - exact).abs().sum())
        err_want += float((y.float() - exact).abs().sum())
        assert bool(((x.float() - y.float()).abs()
                     <= R.plain_chain_bound(x, y, a, w, cs)).all()), path
    assert err_got <= err_want


SCENARIO_ROUNDS = {
    # (strategy factory settings, engine settings, kernels that must launch)
    "unstable": ({}, {}, ("fuse", "aggregate")),
    # budget 1.1 on the reduced fleet: a depth-1 cohort of width tiers
    # 0.25 and 1.0, so the fused cross-tier update runs tier_sum
    "hasfl-ladder": (dict(width_tiers=(0.25, 0.5, 0.75, 1.0),
                          time_budget_factor=1.1),
                     dict(cross_tier="fused"),
                     ("fuse", "aggregate", "tier_sum")),
}


def _scenario_round(cuda, name, use_pallas):
    """One round of the reduced ViT (6 clients, seed 0) under ``name``;
    returns (record, params, launches by kernel)."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.federated import Engine
    from repro_torch.federated.strategies import HASFL, UnstableParticipation
    from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
    from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf, tier_sum_leaf
    skw, ekw, _ = SCENARIO_ROUNDS[name]
    strategy = (UnstableParticipation if name == "unstable" else HASFL)(**skw)
    cfg = get_reduced("vit16_cifar").replace(
        n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
        d_ff=96, image_size=16, n_classes=6, use_pallas=use_pallas)
    eng = Engine(cfg, 6, strategy, device=cuda, seed=0, lr=0.3,
                 local_steps=2, batch_size=8, availability=0.8, **ekw)
    wrappers = {"fuse": fuse_leaf, "aggregate": aggregate_leaf,
                "tier_sum": tier_sum_leaf}
    before = {k: f.launches for k, f in wrappers.items()}
    rec = eng.run_round()
    torch.cuda.synchronize()
    return rec, eng.state.params, {k: f.launches - before[k]
                                   for k, f in wrappers.items()}


@pytest.mark.parametrize("name", sorted(SCENARIO_ROUNDS))
def test_scenario_round_on_the_card_launches_the_kernels(cuda, name):
    """One round of ``unstable`` and of ``hasfl`` on the width ladder with
    the kernels on launches each kernel of their path, and agrees with the
    same round with the kernels off (loss and params within 1e-4), which
    launches neither ``aggregate`` nor ``tier_sum``: the flag selects
    those, while Phase 3 on the card runs ``fuse`` either way."""
    from repro_torch.tree import tree_flatten_with_path, tree_get
    rec, params, launches = _scenario_round(cuda, name, True)
    for k in SCENARIO_ROUNDS[name][2]:
        assert launches[k] > 0, (k, launches)
    prec, pparams, plaunches = _scenario_round(cuda, name, False)
    assert not (plaunches["aggregate"] or plaunches["tier_sum"]), plaunches
    assert abs(rec["loss"] - prec["loss"]) <= 1e-4
    for path, x in tree_flatten_with_path(params):
        torch.testing.assert_close(x, tree_get(pparams, path), rtol=0,
                                   atol=1e-4, msg=str(path))


@pytest.mark.parametrize("S", [8192, 8160])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_at_mixtrals_windowed_shape(cuda, dtype, tol,
                                                           S):
    """Mixtral-8x7B's prefill shape past its window: S 8,192 (and the
    serve path's teacher-forced 8,160, not a whole tile), 32 query and 8
    KV heads of 128, window 4,096 (the kernel skips the tiles behind the
    window), at B 1."""
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((1, S, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((1, S, 8, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, S, 8, 128), generator=g, device=cuda).to(dtype)
    with torch.no_grad():
        got = O.flash_attention(q, k, v, causal=True, window=4096)
        want = R.flash_attention_ref(q, k, v, causal=True, window=4096)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_moe_prefill_past_its_window_on_the_card(cuda):
    """Reduced Mixtral (window 16) over a 64-token prompt: with the
    kernels on, ``flash_attention`` launches once a layer, with the
    window; the logits and the rolled cache agree with the kernels off
    (which launch nothing) within 1e-4, and every slot holds a position
    of its own residue."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import init_params
    cfg = get_reduced("mixtral_8x7b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=g, device=cuda)
    out = {}
    for on in (True, False):
        before = flash_attention.launches
        logits, cache = make_prefill_step(cfg.replace(use_pallas=on),
                                          decode_budget=4)(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        assert flash_attention.launches - before == (cfg.n_layers if on
                                                     else 0)
        out[on] = (logits, cache)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out[True][1]["k"], out[False][1]["k"],
                               rtol=1e-4, atol=1e-4)
    pos = out[True][1]["pos"]
    W = cfg.sliding_window
    assert pos.shape[1] == W
    assert bool((pos % W == torch.arange(W, device=cuda)).all())
    assert int(pos.min()) == 64 - W


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_at_whispers_decoder_shape(cuda, dtype, tol):
    """Whisper-small's decoder prefill in ``chip_smoke.py``: 16 requests
    of 224 tokens, 12 query and 12 KV heads of 64 (multi-head, not
    grouped), causal."""
    from repro_torch.kernels.flash_attention import ops as O, ref as R
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((16, 224, 12, 64), generator=g,
                           device=cuda).to(dtype) for _ in range(3))
    with torch.no_grad():
        got = O.flash_attention(q, k, v, causal=True)
        want = R.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_whisper_prefill_on_the_card_launches_flash_in_each_decoder_layer(
        cuda):
    """Whisper-small whole in fp32, 2 requests of 1,500 frames and 64
    decoder tokens: with the kernels on ``flash_attention`` launches once
    in each of the 12 decoder layers (never in the encoder); the logits
    and the self-attention cache agree with the kernels off (which launch
    nothing) within 1e-3 of the largest, and the cross-attention cache,
    which no kernel touches, is the same bit for bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import init_params
    cfg = get_config("whisper_small").replace(dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g,
                                     device=cuda),
             "frames": torch.randn((2, cfg.enc_frames, cfg.d_model),
                                   generator=g, device=cuda)}
    out = {}
    for on in (True, False):
        before = flash_attention.launches
        out[on] = make_prefill_step(cfg.replace(use_pallas=on),
                                    decode_budget=4)(params, batch)
        torch.cuda.synchronize()
        assert flash_attention.launches - before == (cfg.n_layers if on
                                                     else 0)
    (lg_on, c_on), (lg_off, c_off) = out[True], out[False]
    scale = float(lg_off.abs().max())
    assert float((lg_on - lg_off).abs().max()) <= 1e-3 * scale
    assert float((c_on["k"] - c_off["k"]).abs().max()) <= 1e-3 * float(
        c_off["k"].abs().max())
    assert c_on["cross_k"].shape == (12, 2, 1500, 12, 64)
    for key in ("cross_k", "cross_v"):
        assert torch.equal(c_on[key], c_off[key]), key


# ------------------------------------------------------- the sanitizer mode

def _vit_engine(cuda, **kw):
    """The reduced ViT fleet of the scenario rounds (6 clients, seed 0,
    kernels on) under ``ssfl``."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.federated import Engine
    cfg = get_reduced("vit16_cifar").replace(
        n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
        d_ff=96, image_size=16, n_classes=6, use_pallas=True)
    return Engine(cfg, 6, "ssfl", device=cuda, seed=0, lr=0.3,
                  local_steps=2, batch_size=8, availability=0.8, **kw)


def _launch_counts():
    from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
    from repro_torch.kernels.tpgf_fusion.ops import fuse_leaf
    return {"fuse": fuse_leaf.launches, "aggregate": aggregate_leaf.launches}


def test_sanitized_round_on_the_card_launches_and_is_bit_for_bit(cuda):
    """A sanitized round with the kernels on launches ``fuse`` and
    ``aggregate`` and equals the unsanitized round bit for bit (losses,
    params, local heads): the float check only reads."""
    from repro_torch.tree import tree_leaves
    plain, checked = _vit_engine(cuda), _vit_engine(cuda, sanitize=True)
    for _ in range(2):
        before = _launch_counts()
        rec = checked.run_round()
        torch.cuda.synchronize()
        after = _launch_counts()
        assert all(after[k] > before[k] for k in after), (before, after)
        assert plain.run_round()["loss"] == rec["loss"]
    for tree in ("params", "local_heads"):
        for x, y in zip(tree_leaves(getattr(plain.state, tree)),
                        tree_leaves(getattr(checked.state, tree))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("bad", [10_000_000, -1],
                         ids=["past-the-end", "negative"])
def test_out_of_bounds_index_on_the_card_raises_before_any_launch(cuda, bad):
    """The gather guard raises on the host before any index reaches the
    card (where it would be a device-side assert the context does not
    survive) and before any kernel launch; the next round then runs."""
    import numpy as np
    from repro_torch.federated.sanitize import SlotSanitizerError
    eng = _vit_engine(cuda, sanitize=True)
    orig = eng._sample_indices

    def poisoned(ids, steps, batch_size=None):
        out = orig(ids, steps, batch_size)
        out[0, 0, 0] = bad
        return out

    eng._sample_indices = poisoned
    before = _launch_counts()
    with pytest.raises(SlotSanitizerError, match="out of bounds"):
        eng.run_round()
    torch.cuda.synchronize()
    assert _launch_counts() == before
    eng._sample_indices = orig
    assert np.isfinite(eng.run_round()["loss"])
    assert all(v > before[k] for k, v in _launch_counts().items())


def test_float_check_ignores_the_kernels_uninitialised_outputs(cuda):
    """Every wrapper allocates its output with ``empty_like`` and writes
    it from the kernel; the allocator is first handed back NaN-filled
    blocks, so a check of the uninitialised outputs would trip. The
    results read afterwards are checked and finite."""
    from repro_torch.federated.sanitize import FloatCheck
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.layer_aggregate.ops import aggregate_leaf
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.tpgf_fusion.ops import (fuse_leaf, sumsq_leaf,
                                                     tier_sum_leaf)
    g = torch.Generator(device=cuda).manual_seed(11)
    rand = lambda *s: torch.randn(s, generator=g, device=cuda)
    a, b, c, s = rand(4, 96, 48), rand(4, 96, 48), rand(6, 4, 999), rand(4, 999)
    w = torch.tensor(0.3, device=cuda)
    q, k, v = (rand(2, 256, 4, 64).bfloat16() for _ in range(3))
    x, B, C = rand(2, 256, 4, 64), rand(2, 256, 16), rand(2, 256, 16)
    dt = torch.rand((2, 256, 4), generator=g, device=cuda) * 0.1 + 0.01
    A, D = -torch.rand(4, generator=g, device=cuda) - 0.5, rand(4)
    garbage = torch.full((64 << 20,), float("nan"), device=cuda)
    del garbage                                   # NaN blocks, now free
    with FloatCheck() as check:
        outs = [fuse_leaf(a, b, w), tier_sum_leaf([a, b], torch.rand(
                    2, generator=g, device=cuda)),
                sumsq_leaf(a), aggregate_leaf(c, torch.rand(
                    (6, 4), generator=g, device=cuda), s, 0.01),
                flash_attention(q, k, v, causal=True),
                *ssd_scan(x, dt, A, B, C, D)]
        total = sum(o.float().sum() for o in outs)
    assert check.failure() is None
    assert bool(torch.isfinite(total))


# -------------------------------------------- the kernels on an LM mesh

@pytest.fixture
def one_rank_mesh(cuda):
    """A (1, 1) ``("data", "model")`` mesh over a one-rank NCCL group made
    for the test, destroyed after it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    mesh = make_test_mesh((1, 1), device=cuda)
    yield mesh
    dist.destroy_process_group()


def _mesh_case(kind, mesh, cuda):
    """(launches, result) of a reduced model's step with the kernels on,
    on ``mesh`` (None: meshless): a Llama prefill (flash), a Mamba2
    prefill (ssd_scan) or a Mamba2 train step (fuse)."""
    from repro_torch.configs import base
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssd_scan import ops as SS
    from repro_torch.kernels.tpgf_fusion import ops as TF
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models.model import init_params
    arch = "llama3_2_3b" if kind == "flash_attention" else "mamba2_2_7b"
    cfg = base.get_reduced(arch).replace(use_pallas=True, microbatches=1)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, mesh=mesh)
    toks = torch.randint(0, cfg.vocab, (2, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    counters = {"flash_attention": FA.flash_attention,
                "ssd_scan": SS.ssd_scan, "fuse": TF.fuse_leaf}
    before = counters[kind].launches
    if kind == "fuse":
        step, opt = make_train_step(cfg)
        _, _, m = step(params, opt.init(params),
                       {"tokens": toks[:, :32], "labels": toks[:, 1:]})
        out = torch.stack([m["loss_client"], m["loss_server"]])
    else:
        out = make_prefill_step(cfg)(params, {"tokens": toks[:, :32]})[0]
        if hasattr(out, "full_tensor"):
            out = out.full_tensor()
    return counters[kind].launches - before, out


@pytest.mark.parametrize("kind", ["flash_attention", "ssd_scan", "fuse"])
def test_kernels_launch_through_local_map_on_a_mesh(cuda, one_rank_mesh,
                                                    kind):
    """Each kernel reaches the card through its region's ``local_map`` on
    a (1, 1) NCCL mesh: it launches as often as in the meshless run, and
    the result is the meshless run's, bit for bit."""
    want_n, want = _mesh_case(kind, None, cuda)
    got_n, got = _mesh_case(kind, one_rank_mesh, cuda)
    assert got_n == want_n > 0
    assert torch.equal(got, want)


def test_a_gloo_mesh_refuses_cuda_tensors(cuda):
    """Gloo runs only all_reduce and broadcast on CUDA tensors: an LM mesh
    of CUDA tensors over gloo raises, and so does placing a CUDA tensor
    on a gloo mesh of CPU tensors."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="gloo runs only all_reduce"):
            make_test_mesh((1, 1), device=cuda)
        mesh = make_test_mesh((1, 1), device="cpu")
        with pytest.raises(ValueError, match="gloo runs only all_reduce"):
            SH.place(torch.zeros(4, 4, device=cuda), SH.P(None, None), mesh)
    finally:
        dist.destroy_process_group()


# ------------------------------------------ the experts at Mixtral's widths

def _copy_kernels(cuda, fn):
    """(name, ms) of every copy on the card (a ``direct_copy`` kernel, the
    strided ``elementwise_kernel<128, 4, ...>``, a ``Memcpy``) in one run
    of ``fn``, traced by ``torch.profiler`` after an untraced run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.ones(1, device=cuda).add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=cuda).add_(1)   # the profiler may miss its first
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type().name != "CPU"
            and any(k in e.name() for k in ("direct_copy", "Memcpy",
                                            "elementwise_kernel<128, 4,"))]


def test_expert_ffn_at_mixtral_widths_copies_no_weight(cuda):
    """One ``expert_ffn`` forward and backward at Mixtral-8x7B's widths (E
    8, d_model 4,096, d_ff 14,336, n 1,024 tokens, bf16) makes no copy on
    the card that lasts 0.1 ms or more: moving the E·n·d_ff elements of a
    gate product (470 MB read and written) takes 0.14 ms at the card's
    3.35 TB/s, a weight four times that. The broadcast ``torch.matmul(x
    [n, dm], w [E, dm, dff])`` on the same inputs makes such copies (its
    fold). The gate/up pair's input and weight gradients against fp32
    sums of the same bf16 operands: each error norm within the one the
    fold reaches (the weight gradients round the same K = n sums, so
    within 1 % of it)."""
    from repro_torch.models import layers as L, moe as MOE
    E, dm, dff, n = 8, 4096, 14336, 1024
    g = torch.Generator(device=cuda).manual_seed(27)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=cuda)).to(
            torch.bfloat16)
    # leaves that take gradients: torch.matmul folds only then
    p = {k: r(*s, scale=0.02).requires_grad_() for k, s in (
        ("w_gate", (E, dm, dff)), ("w_up", (E, dm, dff)),
        ("w_down", (E, dff, dm)))}
    x, dy = r(n, dm).requires_grad_(), r(E, n, dm)

    def matmul_ffn(w, xg):
        h = torch.matmul(xg, w["w_gate"])
        return torch.matmul(L.silu(h) * torch.matmul(xg, w["w_up"]),
                            w["w_down"])

    def long_copies(ffn):
        return [c for c in _copy_kernels(cuda, lambda: torch.autograd.grad(
            ffn(p, x), [x, *p.values()], dy)) if c[1] >= 0.1]
    assert long_copies(MOE.expert_ffn) == []
    assert len(long_copies(matmul_ffn)) >= 2

    dg, du = r(E, n, dff), r(E, n, dff)

    def grads(pair):
        return torch.autograd.grad(pair(p, x), [x, p["w_gate"], p["w_up"]],
                                   (dg, du))
    new = grads(MOE.gate_up)
    old = grads(lambda w, xg: (torch.matmul(xg, w["w_gate"]),
                               torch.matmul(xg, w["w_up"])))
    del dy
    err = {k: [0.0, 0.0] for k in ("dx", "w_gate", "w_up")}
    with torch.no_grad():
        xf = x.float()
        want_dx = torch.zeros((n, dm), device=cuda)
        for e in range(E):
            for i, (k, d) in enumerate((("w_gate", dg), ("w_up", du)), 1):
                want_dx += d[e].float() @ p[k][e].float().mT
                want = xf.mT @ d[e].float()
                for j, got in enumerate((new[i], old[i])):
                    err[k][j] += float((got[e].float() - want).square().sum())
        for j, got in enumerate((new[0], old[0])):
            err["dx"][j] = float((got.float() - want_dx).square().sum())
    assert err["dx"][0] <= err["dx"][1], err
    for k in ("w_gate", "w_up"):
        assert err[k][0] <= 1.01 ** 2 * err[k][1], err
