"""The port's ``flash_attention`` and ``blockwise_attention`` against the
JAX package on the same numpy inputs.

On CPU tensors the wrapper takes its plain version
(``ref.flash_attention_ref``); it is held against the JAX Pallas kernel
(``ops.flash_attention``, interpret mode, as ``tests/test_kernels.py``
runs it) and against the JAX oracle, at ``test_kernels.py``'s five shape
cases, fp32 and bf16, at the reference's own tolerances: 2e-5 (fp32) and
3e-2 (bf16). ``blockwise_attention`` is held to the JAX one at
``test_kernels.py``'s blockwise cases (rtol 1e-4, atol 2e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as JO  # noqa: E402
from repro.kernels.flash_attention import ref as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.kernels.flash_attention import ops as TO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

CASES = [
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 4, 4, 64, True, 64),
    (2, 128, 8, 1, 32, True, 0),      # MQA
    (1, 128, 4, 2, 32, False, 0),
    (1, 256, 2, 2, 128, True, 128),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape_q, shape_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.tensor(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_kernel_outputs():
    """The JAX Pallas kernel (interpret mode) and oracle, once per case."""
    out = {}
    for i, (B, S, H, K, hd, causal, win) in enumerate(CASES):
        for dtype in TOL:
            (q, k, v), _ = _inputs((B, S, H, hd), (B, S, K, hd), dtype, i)
            out[i, dtype] = (
                _f32(JO.flash_attention(q, k, v, causal=causal, window=win)),
                _f32(JR.flash_attention_ref(q, k, v, causal=causal,
                                            window=win)))
    return out


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"B{c[0]}S{c[1]}H{c[2]}K{c[3]}hd{c[4]}"
                              f"{'c' if c[5] else 'nc'}w{c[6]}"
                              for c in CASES])
def test_flash_attention_matches_jax_kernel(jax_kernel_outputs, case, dtype):
    B, S, H, K, hd, causal, win = CASES[case]
    _, (q, k, v) = _inputs((B, S, H, hd), (B, S, K, hd), dtype, case)
    before = TO.flash_attention.launches
    got = TO.flash_attention(q, k, v, causal=causal, window=win)
    assert TO.flash_attention.launches == before   # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    jax_kernel, jax_ref = jax_kernel_outputs[case, dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), jax_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), jax_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _f32(TR.flash_attention_ref(q, k, v, causal=causal, window=win)),
        _f32(got), rtol=0, atol=0)


@pytest.mark.parametrize("causal,win", [(True, 0), (True, 100), (False, 0)])
def test_blockwise_attention_matches_jax(causal, win):
    (q, k, v), (tq, tk, tv) = _inputs((2, 512, 4, 32), (2, 512, 2, 32),
                                      "float32", 7)
    want = JL.blockwise_attention(q, k, v, causal=causal, window=win,
                                  bq=128, bk=128)
    got = TL.blockwise_attention(tq, tk, tv, causal=causal, window=win,
                                 bq=128, bk=128)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=2e-5)
    oracle = TR.flash_attention_ref(tq, tk, tv, causal=causal, window=win)
    np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=1e-4,
                               atol=2e-5)


def test_blockwise_attention_needs_whole_blocks():
    x = torch.zeros((1, 300, 2, 32))
    with pytest.raises(ValueError, match="blocks"):
        TL.blockwise_attention(x, x, x, causal=True, bq=128, bk=128)


def test_flash_attention_wrapper_refuses_other_devices():
    x = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TO.flash_attention(x, x, x, causal=True)
