"""The port's ViT layers and model against the JAX package at a reduced
ViT: logits, losses and gradients of ``local_loss``/``server_split_loss``
at d in {1, 2, 3}. The JAX side runs its runtime-depth form (a traced
``jnp.int32(d)`` over full-``L`` views, which the reference pins bit-exact
to its static slice); the port slices the stack at ``d``.

Tolerances: rtol 1e-5 / atol 1e-6 on values, 1e-5 on gradients (fp32 on
both sides; the two frameworks sum matmuls in different orders).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.federated.engine import local_predict, predict  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flat(tree):
    if isinstance(tree, dict) and tree and isinstance(
            next(iter(jax.tree.leaves(tree)), None), torch.Tensor):
        return {p: _np(x) for p, x in tree_flatten_with_path(tree)}
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    jcfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    tcfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # non-trivial norms and biases, so every parameter shapes the output
    rng = np.random.default_rng(5)
    np_p = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)
    jp = jax.tree.map(jnp.asarray, np_p)
    tp = bridge.to_torch(np_p, device="cpu")
    batch_np = {"images": rng.normal(size=(5, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 6, 5).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tb = {"images": torch.as_tensor(batch_np["images"]),
          "label": torch.as_tensor(batch_np["label"].astype(np.int64))}
    return jcfg, tcfg, jp, tp, jb, tb


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("shape", [(3, 7, 48), (2, 64)])
def test_layernorm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, shape).astype(np.float32)
    s = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.layernorm(torch.as_tensor(x), torch.as_tensor(s),
                         torch.as_tensor(b))),
        np.asarray(JL.layernorm(x, s, b)), **VAL)


@pytest.mark.parametrize("H,K,causal", [(4, 4, False), (4, 2, True),
                                        (6, 1, False)])
def test_attention_and_mask(H, K, causal):
    rng = np.random.default_rng(1)
    B, S, hd = 2, 9, 8
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jm = JL.make_attn_mask(jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                           window=4 if causal else 0)
    tpos = torch.tensor(pos)
    tm = TL.make_attn_mask(tpos, tpos,
                           causal=causal, window=4 if causal else 0)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    got = TL.attention(*(torch.tensor(a) for a in (q, k, v)), mask=tm)
    want = JL.attention(q, k, v, mask=jm)
    np.testing.assert_allclose(_np(got), np.asarray(want), **VAL)


def test_gelu_mlp_is_the_tanh_approximation(setup):
    jcfg, tcfg, jp, tp, _, _ = setup
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    tl = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    np.testing.assert_allclose(
        _np(TL.mlp_apply(tcfg, tl, torch.as_tensor(x))),
        np.asarray(JL.mlp_apply(jcfg, jl, x)), **VAL)


def test_softmax_xent():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 4, (7, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 7)
    np.testing.assert_allclose(
        float(TL.softmax_xent(torch.as_tensor(logits),
                              torch.as_tensor(labels))),
        float(JL.softmax_xent(logits, jnp.asarray(labels))), **VAL)


# -------------------------------------------------------------------- model

def test_embed_inputs_patchify_order(setup):
    jcfg, tcfg, jp, tp, jb, tb = setup
    jh, jpos = JM.embed_inputs(jcfg, jp, jb)
    th, tpos = TM.embed_inputs(tcfg, tp, tb)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **VAL)
    np.testing.assert_array_equal(_np(tpos), np.asarray(jpos))


def test_predict(setup):
    jcfg, tcfg, jp, tp, jb, tb = setup
    np.testing.assert_allclose(_np(TM.predict(tcfg, tp, tb)),
                               np.asarray(predict(jcfg, jp, jb)), **VAL)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_split_forward_logits_and_losses(setup, d):
    jcfg, tcfg, jp, tp, jb, tb = setup
    jc, js, jl = JSN.split_params(jcfg, jp, None)
    tc, ts, tl = TSN.split_params(tcfg, tp, d)
    jz, _ = JM.client_apply(jcfg, jc, jb, length=jnp.int32(d))
    tz, _ = TM.client_apply(tcfg, tc, tb)
    np.testing.assert_allclose(_np(tz), np.asarray(jz), **VAL)
    np.testing.assert_allclose(_np(TM.local_logits(tcfg, tl, tz)),
                               np.asarray(JM.local_logits(jcfg, jl, jz)),
                               **VAL)
    jlog, _ = JM.server_apply(jcfg, js, jz, jb, length=jnp.int32(d))
    tlog, _ = TM.server_apply(tcfg, ts, tz, tb)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **VAL)
    np.testing.assert_allclose(
        float(TM.server_split_loss(tcfg, ts, tz, tb)),
        float(JM.server_split_loss(jcfg, js, jz, jb, length=jnp.int32(d))),
        **VAL)
    np.testing.assert_allclose(
        _np(TM.local_predict(tcfg, tp, tb, d)),
        np.asarray(local_predict(jcfg, jp, jb, d)), **VAL)


def _compare_grads(got_tree, want_tree, rows):
    """``rows`` slices the JAX full-L stack gradient down to the port's
    depth window; the rows outside the window must be exactly zero."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = want[k]
        if k[0] == "layers":
            outside = np.delete(w, np.arange(w.shape[0])[rows], axis=0)
            assert not outside.any(), k
            w = w[rows]
        np.testing.assert_allclose(g, w, err_msg=str(k), **GRAD)


def _requires_grad(tree):
    return tree_map(lambda x: x.clone().requires_grad_(), tree)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_local_loss_gradients(setup, d):
    jcfg, tcfg, jp, tp, jb, tb = setup
    jc, _, jl = JSN.split_params(jcfg, jp, None)

    def jloss(cp, lp):
        z, _ = JM.client_apply(jcfg, cp, jb, length=jnp.int32(d))
        return JM.local_loss(jcfg, lp, z, jb)

    jgc, jgl = jax.grad(jloss, argnums=(0, 1))(jc, jl)
    tc, _, tl = (_requires_grad(t) for t in TSN.split_params(tcfg, tp, d))
    z, _ = TM.client_apply(tcfg, tc, tb)
    TM.local_loss(tcfg, tl, z, tb).backward()
    _compare_grads(tree_map(lambda x: x.grad, tc), jgc, slice(0, d))
    _compare_grads(tree_map(lambda x: x.grad, tl), jgl, slice(None))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_server_split_loss_gradients(setup, d):
    jcfg, tcfg, jp, tp, jb, tb = setup
    jc, js, _ = JSN.split_params(jcfg, jp, None)
    jz, _ = JM.client_apply(jcfg, jc, jb, length=jnp.int32(d))
    jgs, jgz = jax.grad(
        lambda sp, z: JM.server_split_loss(jcfg, sp, z, jb,
                                           length=jnp.int32(d)),
        argnums=(0, 1))(js, jz)
    ts = _requires_grad(TSN.split_params(tcfg, tp, d)[1])
    z = torch.tensor(np.asarray(jz)).requires_grad_()
    TM.server_split_loss(tcfg, ts, z, tb).backward()
    _compare_grads(tree_map(lambda x: x.grad, ts), jgs, slice(d, None))
    np.testing.assert_allclose(_np(z.grad), np.asarray(jgz), **GRAD)


def test_other_families_raise():
    """A family outside the JAX package's zoo is refused (every family of
    the zoo, the audio encoder-decoder last, is ported)."""
    cfg = TB.get_reduced("vit16_cifar").replace(family="speech")
    with pytest.raises(NotImplementedError, match="model zoo"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert math.isclose(TB.get_config("vit16_cifar").d_model, 768)


def test_bf16_attention_within_one_ulp_of_reference():
    """bf16 attention keeps fp32 scores and an fp32 PV product, as the
    reference's ``preferred_element_type=float32`` does: the port's output
    is within one bf16 ulp of the JAX one on the same inputs."""
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 2, 128, 4, 2, 64
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32) * 2.0
               for n in (H, K, K))
    pos = np.broadcast_to(np.arange(S), (B, S))
    jmask = JL.make_attn_mask(jnp.asarray(pos), jnp.asarray(pos),
                              causal=True)
    want = np.asarray(JL.attention(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)), mask=jmask),
                      np.float32)
    tpos = torch.tensor(pos)
    got = TL.attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)),
                       mask=TL.make_attn_mask(tpos, tpos, causal=True))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at each output's magnitude (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= ulp), float((err / ulp).max())
