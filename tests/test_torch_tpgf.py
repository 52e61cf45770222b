"""TPGF (Alg. 2) in the port against the JAX package, and the ``fuse`` and
``sumsq`` kernels' plain versions against the reference's Pallas kernels.

``tpgf_grads_split`` runs at d in {1, 2, 3} with the server reachable and
unreachable; the JAX side takes its runtime-depth form over full-``L``
views, the port slices at ``d``. Tolerances: 1e-5 in fp32; 2e-2 for bf16
leaves (the reference's own kernel tolerances). The JAX kernel runs in
interpret mode, as ``tests/test_kernels.py`` runs it on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.kernels.tpgf_fusion import kernel as JFK  # noqa: E402
from repro.kernels.tpgf_fusion import ops as JFO  # noqa: E402
from repro.kernels.tpgf_fusion import ref as JFR  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.kernels.tpgf_fusion import ops as TFO  # noqa: E402
from repro_torch.kernels.tpgf_fusion import ref as TFR  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat_j(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {p: x.detach().numpy() for p, x in tree_flatten_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    jcfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    tcfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    np_p = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)
    batch_np = {"images": rng.normal(size=(6, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 6, 6).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tb = {"images": torch.tensor(batch_np["images"]),
          "label": torch.tensor(batch_np["label"].astype(np.int64))}
    jsplit = jax.jit(functools.partial(JT.tpgf_grads_split, jcfg, jcfg))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_p),
            bridge.to_torch(np_p, device="cpu"), jb, tb, jsplit)


@pytest.mark.parametrize("avail", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_tpgf_grads_split_matches(setup, d, avail, use_pallas):
    """The port's ``use_pallas=True`` routes Eq. 4 through ``fuse_tree``
    (its plain version on the CPU); both forms hold to the reference's
    plain path."""
    jcfg, tcfg, jp, tp, jb, tb, jsplit = setup
    jc, js, jl = JSN.split_params(jcfg, jp, None)
    jo = jsplit(jc, js, jl, jb, jnp.int32(d),
                server_available=jnp.asarray(avail))
    tcfg = tcfg.replace(use_pallas=use_pallas)
    tc, ts, tl = TSN.split_params(tcfg, tp, d)
    to = TT.tpgf_grads_split(tcfg, tcfg, tc, ts, tl, tb, d,
                             server_available=avail)
    for name in ("loss_client", "loss_server", "w_client"):
        np.testing.assert_allclose(float(getattr(to, name)),
                                   float(getattr(jo, name)), **TOL)
    for got_tree, want_tree, rows in (
            (to.g_client, jo.g_client, slice(0, d)),
            (to.g_server, jo.g_server, slice(d, None)),
            (to.g_local, jo.g_local, slice(None))):
        got, want = _flat_t(got_tree), _flat_j(want_tree)
        assert got.keys() == want.keys()
        for k, g in got.items():
            w = want[k][rows] if k[0] == "layers" else want[k]
            np.testing.assert_allclose(g, w, err_msg=str(k), **TOL)
    if not avail:
        assert float(to.w_client) == 1.0
        assert all(not x.any() for x in _flat_t(to.g_server).values())


@pytest.mark.parametrize("variant", ["full", "no_loss", "no_depth", "equal"])
def test_tpgf_weight_and_fused_loss_variants(variant):
    rng = np.random.default_rng(0)
    lc = rng.uniform(0.1, 3.0, 5).astype(np.float32)
    ls = rng.uniform(0.1, 3.0, 5).astype(np.float32)
    for d, ds in ((1, 3), (2, 2), (5, 7)):
        want_w = JT.tpgf_weight(jnp.asarray(lc), jnp.asarray(ls), d, ds,
                                variant=variant)
        got_w = TT.tpgf_weight(torch.tensor(lc), torch.tensor(ls), d, ds,
                               variant=variant)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
        want_l = JT.fused_loss(jnp.asarray(lc), jnp.asarray(ls), d, ds,
                               variant=variant)
        got_l = TT.fused_loss(torch.tensor(lc), torch.tensor(ls), d, ds,
                              variant=variant)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    with pytest.raises(ValueError):
        TT.tpgf_weight(torch.tensor(1.0), torch.tensor(1.0), 1, 1,
                       variant="bogus")


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_l2(scale):
    rng = np.random.default_rng(1)
    tree = {"a": (scale * rng.normal(size=(4, 5))).astype(np.float32),
            "b": {"c": (scale * rng.normal(size=(7,))).astype(np.float32)}}
    jc, jn = JT.clip_by_global_l2(jax.tree.map(jnp.asarray, tree), 0.5)
    tc, tn = TT.clip_by_global_l2(bridge.to_torch(tree, device="cpu"), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    for k, v in _flat_j(jc).items():
        np.testing.assert_allclose(_flat_t(tc)[k], v, **TOL)


@pytest.mark.parametrize("shape", [(7,), (130,), (33, 65), (4, 7, 13),
                                   (256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_plain_version_matches_pallas_kernel(shape, dtype):
    rng = np.random.default_rng(42)
    a_np = rng.normal(size=shape).astype(np.float32)
    b_np = rng.normal(size=shape).astype(np.float32)
    ja, jb = jnp.asarray(a_np, dtype), jnp.asarray(b_np, dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ta, tb = torch.tensor(a_np).to(tdt), torch.tensor(b_np).to(tdt)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    want_kernel = np.asarray(JFO.fuse_leaf(ja, jb, 0.3, 0.7), np.float32)
    want_ref = np.asarray(JFR.fuse(ja, jb, 0.3, 0.7), np.float32)
    before = TFO.fuse_leaf.launches
    got = TFO.fuse_leaf(ta, tb, torch.tensor(0.3), 0.7)
    assert TFO.fuse_leaf.launches == before   # CPU tensors: plain version
    assert got.dtype == tdt
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        got.float().numpy(),
        TFR.fuse(ta, tb, torch.tensor(0.3), 0.7).float().numpy())


def test_fuse_tree_matches_fuse_gradients_and_refuses_tau():
    """Without ``tau``: bit-exact to ``fuse_gradients``. With ``tau=0.5``
    (the clip fused in through ``sumsq``): within the reference's own
    tolerances of its ``fuse_tree(tau=0.5)`` (Pallas, interpret mode) and
    of ``clip_by_global_l2`` + Eq. 4, at ``tests/test_kernels.py``'s
    shapes. A negative ``tau`` is refused."""
    rng = np.random.default_rng(2)
    shapes = {"a": (17, 9), "b": (64,)}
    gc_np = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    gs_np = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    gc = bridge.to_torch(gc_np, device="cpu")
    gs = bridge.to_torch(gs_np, device="cpu")
    w = torch.tensor(0.4)
    got = TFO.fuse_tree(gc, gs, w)
    want = TT.fuse_gradients(gc, gs, w)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    before = TFO.sumsq_leaf.launches
    got = TFO.fuse_tree(gc, gs, w, tau=0.5)
    assert TFO.sumsq_leaf.launches == before    # CPU: plain version
    want_kernel = JFO.fuse_tree(jax.tree.map(jnp.asarray, gc_np),
                                jax.tree.map(jnp.asarray, gs_np),
                                jnp.float32(0.4), tau=0.5)
    clipped, _ = TT.clip_by_global_l2(gc, 0.5)
    want_plain = TT.fuse_gradients(clipped, gs, w)
    for k in ("a", "b"):
        for want in (np.asarray(want_kernel[k]), want_plain[k].numpy()):
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="tau"):
        TFO.fuse_tree(gc, gs, w, tau=-1.0)


def test_sumsq_plain_version_matches_pallas_kernel():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(1000,)).astype(np.float32)
    t, _ = JFO._to_tiles(jnp.asarray(x))
    want = float(JFK.sumsq_2d(t))
    got = TFO.sumsq_leaf(torch.tensor(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert float(got) == float(TFR.sumsq(torch.tensor(x)))
    # the total accumulates in place, leaf after leaf
    total = torch.zeros(())
    for part in (x[:300], x[300:]):
        TFO.sumsq_leaf(torch.tensor(part), total)
    np.testing.assert_allclose(float(total), want, rtol=1e-5)
