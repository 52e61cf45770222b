"""The port's dense causal LM family against the JAX package, at the four
dense configs' reduced forms (2 layers, d_model 128, vocab 512; fp32).

``prefill`` logits and the per-layer post-rope ``k`` and ``v`` it emits
into the cache are held to the reference's for each config, with the
attention taken by each of the reference's three routes: plain attention
(``use_pallas=False``), the flash kernel (``use_pallas=True``: the JAX
side in interpret mode, the port's wrapper on its plain version for CPU
tensors) and the blockwise loop (its threshold lowered to the test's
sequence length on both sides). Weights cross with
``bridge.to_model_params``; tokens come from ``synthetic_lm_batches`` on
both sides. Tolerance 2e-5 (fp32; the frameworks sum matmuls in other
orders). ``rmsnorm``, ``apply_rope`` and GeGLU are pinned alone, and the
port's ``init_params`` against the reference's shapes, dtypes and
distributions.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.data.synthetic import synthetic_lm_batches as j_lm  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm_batches as t_lm  # noqa
from repro_torch.federated import Engine  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ARCHS = ["llama3_2_3b", "qwen2_5_3b", "gemma_2b", "internlm2_1_8b"]
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 64


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _flat_jax(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed_params(arch, seed=0):
    """The reference's init for the reduced ``arch``, every leaf nudged
    by N(0, 0.05²) so that norms and biases shape the output too; as
    numpy arrays."""
    jcfg = JB.get_reduced(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)


@pytest.fixture(scope="module")
def reference():
    """Per arch: numpy params, the tokens and the reference's prefill
    (logits, cache k, cache v) for each attention route."""
    out = {}
    for arch in ARCHS:
        np_p = perturbed_params(arch)
        jp = jax.tree.map(jnp.asarray, np_p)
        toks = next(j_lm(512, S, B, 1, seed=3))["tokens"]
        runs = {}
        for route in ("plain", "flash", "blockwise"):
            cfg = JB.get_reduced(arch).replace(use_pallas=route == "flash")
            thr = JL.ATTN_BLOCKWISE_THRESHOLD
            if route == "blockwise":
                JL.ATTN_BLOCKWISE_THRESHOLD = S
            try:
                logits, cache = JD.prefill(cfg, jp,
                                           {"tokens": jnp.asarray(toks)})
            finally:
                JL.ATTN_BLOCKWISE_THRESHOLD = thr
            runs[route] = (np.asarray(logits), np.asarray(cache["k"]),
                           np.asarray(cache["v"]))
        out[arch] = (np_p, toks, runs)
    return out


@pytest.mark.parametrize("route", ["plain", "flash", "blockwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(reference, monkeypatch, arch, route):
    np_p, toks, runs = reference[arch]
    cfg = TB.get_reduced(arch).replace(use_pallas=route == "flash")
    if route == "blockwise":
        monkeypatch.setattr(TL, "ATTN_BLOCKWISE_THRESHOLD", S)
    params = bridge.to_model_params(cfg, np_p, device="cpu")
    t_toks = next(t_lm(512, S, B, 1, seed=3))["tokens"]
    np.testing.assert_array_equal(t_toks, toks)
    with torch.no_grad():
        logits, cache = TD.prefill(cfg, params,
                                   {"tokens": torch.as_tensor(t_toks)})
    want_logits, want_k, want_v = runs[route]
    assert logits.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), want_logits, **TOL)
    np.testing.assert_allclose(_np(cache["k"]), want_k, **TOL)
    np.testing.assert_allclose(_np(cache["v"]), want_v, **TOL)
    # the three routes agree with each other as well
    np.testing.assert_allclose(want_logits, runs["plain"][0], **TOL)


def test_use_pallas_routes_through_the_flash_wrapper(reference,
                                                     monkeypatch):
    """Under ``use_pallas`` every layer's causal attention over S > 1
    goes through ``flash_attention`` (here on its plain version)."""
    calls = []
    real = FA.flash_attention

    def spy(q, k, v, *, causal, window):
        calls.append((tuple(q.shape), causal, window))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(FA, "flash_attention", spy)
    np_p, toks, _ = reference["llama3_2_3b"]
    for use_pallas in (True, False):
        cfg = TB.get_reduced("llama3_2_3b").replace(use_pallas=use_pallas)
        params = bridge.to_model_params(cfg, np_p, device="cpu")
        with torch.no_grad():
            TD.prefill(cfg, params, {"tokens": torch.as_tensor(toks)})
    assert calls == [((B, S, cfg.n_heads, cfg.resolved_head_dim), True,
                      0)] * cfg.n_layers


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("shape", [(3, 7, 128), (2, 64)])
def test_rmsnorm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 3.0, shape).astype(np.float32)
    s = rng.normal(0, 0.3, shape[-1]).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rmsnorm(torch.as_tensor(x), torch.as_tensor(s))),
        np.asarray(JL.rmsnorm(x, s)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("hd", [32, 128])
def test_apply_rope(theta, hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    theta))
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(TL.rope_freqs(hd, theta)), np.asarray(JL.rope_freqs(hd, theta)),
        rtol=1e-6)


@pytest.mark.parametrize("mlp", ["geglu", "swiglu"])
def test_gated_mlps(mlp):
    rng = np.random.default_rng(2)
    cfg_j = JB.get_reduced("gemma_2b").replace(mlp=mlp)
    cfg_t = TB.get_reduced("gemma_2b").replace(mlp=mlp)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in
         (("w_gate", (128, 256)), ("w_up", (128, 256)),
          ("w_down", (256, 128)))}
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    want = np.asarray(JL.mlp_apply(cfg_j, p, x))
    got = TL.mlp_apply(cfg_t, {k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_attention_mask_with_valid_slots():
    rng = np.random.default_rng(3)
    pos_q = rng.integers(0, 20, (2, 3)).astype(np.int32)
    pos_k = rng.integers(-1, 20, (2, 11)).astype(np.int32)
    valid = pos_k >= 0
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        want = np.asarray(JL.make_attn_mask(
            jnp.asarray(pos_q), jnp.asarray(pos_k), causal=causal,
            window=window, valid_k=jnp.asarray(valid)))
        got = TL.make_attn_mask(torch.as_tensor(pos_q),
                                torch.as_tensor(pos_k), causal=causal,
                                window=window,
                                valid_k=torch.as_tensor(valid))
        np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_distributions(arch):
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    want = _flat_jax(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    got = {p: x for p, x in tree_flatten_with_path(tp)}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        ref = want[path]
        assert tuple(x.shape) == ref.shape, path
        assert str(x.dtype).replace("torch.", "") == str(ref.dtype), path
        if not ref.any():
            assert not x.any(), path            # zeros stay zeros
            continue
        y = x.numpy()
        assert abs(y.mean()) < 0.1 * ref.std(), path
        assert math.isclose(y.std(), ref.std(), rel_tol=0.05), path
    # the meta form has the same tree without drawing
    meta = TM.init_params(tcfg, None, device="meta")
    assert {p: tuple(x.shape) for p, x in tree_flatten_with_path(meta)} \
        == {p: tuple(x.shape) for p, x in got.items()}


def test_full_size_llama_parameter_count():
    cfg = TB.get_config("llama3_2_3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.rope_theta,
            cfg.dtype) == (28, 3072, 24, 8, 128, 8192, 128256, 5e5,
                           "bfloat16")
    meta = TM.init_params(cfg, None, device="meta")
    assert TM.param_count(meta) == 4_000_754_688
    assert all(x.dtype == torch.bfloat16 for _, x in
               tree_flatten_with_path(meta))


def test_bridge_refuses_a_tree_that_does_not_match():
    np_p = perturbed_params("llama3_2_3b")
    cfg = TB.get_reduced("qwen2_5_3b")          # qkv biases: more leaves
    with pytest.raises(ValueError, match="missing"):
        bridge.to_model_params(cfg, np_p, device="cpu")
    cfg = TB.get_reduced("llama3_2_3b").replace(d_ff=128)
    with pytest.raises(ValueError, match="shape mismatches"):
        bridge.to_model_params(cfg, np_p, device="cpu")
    cfg = TB.get_reduced("llama3_2_3b")
    params = bridge.to_model_params(cfg, np_p, device="cpu",
                                    dtype=torch.bfloat16)
    assert params["embed"].dtype == torch.bfloat16
    params["embed"].zero_()                     # a copy, not a view
    assert np_p["embed"].any()


def test_training_surfaces_train_and_the_engine_points_at_the_step():
    """The LM training surfaces run (the smashed data, both heads' losses
    and the TPGF gradients; ``tests/test_torch_lm_train.py`` holds them to
    the reference); the federated ``Engine`` still refuses an LM config,
    as the reference's cannot run one, and names the train step; a family
    outside the JAX package's zoo is refused."""
    cfg = TB.get_reduced("llama3_2_3b")
    with pytest.raises(NotImplementedError, match="make_train_step"):
        Engine(cfg, 3, "ssfl", device="cpu")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.arange(8).reshape(2, 4) % cfg.vocab
    batch = {"tokens": toks, "labels": (toks + 1) % cfg.vocab}
    z, _ = TM.prefix_apply(cfg, params, batch, 1)
    assert z.shape == (2, 4, cfg.d_model)
    for loss in (TM.local_loss(cfg, params, z, batch),
                 TM.server_loss(cfg, params, z, batch, 1),
                 TM.full_loss(cfg, params, batch)):
        assert loss.shape == () and bool(torch.isfinite(loss))
    from repro_torch.core.tpgf import tpgf_grads
    out = tpgf_grads(cfg, params, batch, 1)
    assert sorted(out.grads) == sorted(params)
    assert out.grads["embed"].abs().sum() > 0
    with pytest.raises(NotImplementedError, match="model zoo"):
        TM.init_params(TB.get_reduced("llama3_2_3b").replace(family="asr"),
                       torch.Generator(), device="cpu")
