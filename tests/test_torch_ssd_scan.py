"""The port's SSD scan (``kernels/ssd_scan``) against the JAX package on
the same numpy inputs.

On CPU tensors the ``ssd_scan`` wrapper takes its plain version
(``ref.ssd_ref`` at the kernel's chunk of 32 rows); it and the port's
``ssd_ref`` are held against the JAX Pallas kernel (``ops.ssd_scan``,
interpret mode, as ``tests/test_kernels.py`` runs it) at that file's four
shapes, at its tolerance (rtol/atol 1e-4: the chunkings differ, so the
sums run in other orders). The port's ``ssd_chunked`` is held to the
JAX one at the same chunk (1e-5), with an initial state ``h0`` and with
the single-chunk fallback; the wrapper to the sequential recurrence
(``test_kernels.py:154``) and to a ragged S; and its input checks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as JO  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402

from repro_torch.kernels.ssd_scan import ops as TO  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as TR  # noqa: E402

# test_kernels.py's shapes: (Bt, S, nh, hd, st, chunk)
CASES = [
    (2, 256, 4, 32, 16, 128),
    (1, 128, 2, 64, 32, 64),
    (2, 64, 3, 32, 16, 64),
    (1, 512, 2, 32, 128, 128),
]
IDS = [f"B{c[0]}S{c[1]}nh{c[2]}hd{c[3]}st{c[4]}c{c[5]}" for c in CASES]
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(Bt, S, nh, hd, st, seed, with_d=True):
    """x, dt, A, B, C, D as numpy arrays, drawn as test_kernels.py draws
    them (dt in [0.01, 0.2], A in −[0.5, 2])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, S, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bt, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    B = rng.normal(size=(Bt, S, st)).astype(np.float32)
    C = rng.normal(size=(Bt, S, st)).astype(np.float32)
    D = rng.normal(size=(nh,)).astype(np.float32) if with_d else None
    return x, dt, A, B, C, D


def _t(arrs):
    return [None if a is None else torch.tensor(a) for a in arrs]


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.fixture(scope="module")
def jax_kernel_outputs():
    """The JAX Pallas kernel (interpret mode), once per case."""
    out = {}
    for i, (Bt, S, nh, hd, st, chunk) in enumerate(CASES):
        arrs = _inputs(Bt, S, nh, hd, st, seed=i)
        y, h = JO.ssd_scan(*_j(arrs), chunk=chunk)
        out[i] = (arrs, np.asarray(y), np.asarray(h))
    return out


@pytest.mark.parametrize("route", ["wrapper", "ssd_ref"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_ssd_scan_matches_jax_kernel(jax_kernel_outputs, case, route):
    arrs, want_y, want_h = jax_kernel_outputs[case]
    chunk = CASES[case][5]
    with torch.no_grad():
        if route == "wrapper":
            y, h = TO.ssd_scan(*_t(arrs))
        else:
            y, h = TR.ssd_ref(*_t(arrs), chunk=chunk)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    np.testing.assert_allclose(y.numpy(), want_y, **KERNEL_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **KERNEL_TOL)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_ssd_chunked_matches_jax_at_the_same_chunk(case):
    Bt, S, nh, hd, st, chunk = CASES[case]
    x, dt, A, B, C, _ = _inputs(Bt, S, nh, hd, st, seed=10 + case)
    want_y, want_h = JSSM.ssd_chunked(*_j((x, dt, A, B, C)), chunk=chunk)
    y, h = TR.ssd_chunked(*_t((x, dt, A, B, C)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               **SAME_CHUNK_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                               **SAME_CHUNK_TOL)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 32)],
                         ids=["h0", "h0-one-chunk-fallback"])
def test_ssd_chunked_with_h0_and_the_single_chunk_fallback(S, chunk):
    """An initial state carries in; S = 48 with chunk 32 falls back to one
    chunk of 48 on both sides."""
    Bt, nh, hd, st = 2, 3, 8, 4
    x, dt, A, B, C, _ = _inputs(Bt, S, nh, hd, st, seed=20)
    h0 = np.random.default_rng(21).normal(
        size=(Bt, nh, hd, st)).astype(np.float32)
    want_y, want_h = JSSM.ssd_chunked(*_j((x, dt, A, B, C)), chunk=chunk,
                                      h0=jnp.asarray(h0))
    y, h = TR.ssd_chunked(*_t((x, dt, A, B, C)), chunk=chunk,
                          h0=torch.tensor(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               **SAME_CHUNK_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                               **SAME_CHUNK_TOL)


def _recurrence(x, dt, A, B, C, D=None):
    """The per-step recurrence, the ground truth of test_kernels.py:154."""
    Bt, S, nh, hd = x.shape
    h = np.zeros((Bt, nh, hd, B.shape[-1]), np.float32)
    ys = []
    for t in range(S):
        a = np.exp(dt[:, t] * A)
        u = x[:, t] * dt[:, t][..., None]
        h = h * a[:, :, None, None] + np.einsum("bhd,bs->bhds", u, B[:, t])
        y = np.einsum("bs,bhds->bhd", C[:, t], h)
        if D is not None:
            y = y + x[:, t] * D[None, :, None]
        ys.append(y)
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S", [32, 77], ids=["S32", "ragged-S77"])
def test_ssd_scan_matches_sequential_recurrence(S):
    """The wrapper == the per-step recurrence: test_kernels.py's shape
    (hd 8, st 4), and a ragged S that the kernel's chunk does not
    divide."""
    arrs = _inputs(1, S, 2, 8, 4, seed=30, with_d=S != 32)
    want_y, want_h = _recurrence(*arrs)
    with torch.no_grad():
        y, h = TO.ssd_scan(*_t(arrs))
    np.testing.assert_allclose(y.numpy(), want_y, **KERNEL_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **KERNEL_TOL)


def test_ssd_scan_stays_finite_where_the_upper_half_overflows():
    """dt near 1 and A = −16: exp(s_i − s_j) above the diagonal is inf
    over one chunk of 256, yet y and h stay finite (the mask comes
    before the product)."""
    Bt, S, nh, hd, st = 1, 256, 2, 8, 4
    x, _, _, B, C, D = _inputs(Bt, S, nh, hd, st, seed=40)
    dt = np.random.default_rng(41).uniform(0.5, 1.0, (Bt, S, nh)).astype(
        np.float32)
    A = np.full((nh,), -16.0, np.float32)
    y, h = TR.ssd_ref(*_t((x, dt, A, B, C, D)), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want_y, want_h = _recurrence(x, dt, A, B, C, D)
    np.testing.assert_allclose(y.numpy(), want_y, **KERNEL_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **KERNEL_TOL)


def test_ssd_scan_wrapper_refuses_grad_and_other_devices():
    arrs = _t(_inputs(1, 16, 2, 8, 4, seed=50))
    arrs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        TO.ssd_scan(*arrs)
    with torch.no_grad():                   # grad mode off: allowed
        y, _ = TO.ssd_scan(*arrs)
    assert not y.requires_grad
    meta = [torch.zeros(a.shape, device="meta") for a in arrs]
    with pytest.raises(ValueError, match="no kernel"):
        TO.ssd_scan(*meta)
