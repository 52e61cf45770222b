"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import). Run them on a machine with
one card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 1e-6 relative for ``fuse`` (it rounds each product on
its own, as the plain formula does) and 1e-5 for ``aggregate`` (it sums
clients in order, the plain version's einsum in another order); bf16 2e-2.
"""
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


def test_aggregate_kernel_all_zero_weights(cuda):
    from repro_torch.kernels.layer_aggregate import ops as O
    c = torch.randn((3, 2, 130), device=cuda)
    s = torch.randn((2, 130), device=cuda)
    got = O.aggregate_leaf(c, torch.zeros((3, 2), device=cuda), s, 0.01)
    ulp = torch.nextafter(s.abs(), torch.full_like(s, float("inf"))) \
        - s.abs()
    assert bool(torch.all((got - s).abs() <= ulp))
