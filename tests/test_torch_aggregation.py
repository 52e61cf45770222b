"""Eq. 6/8 aggregation in the port against the JAX package, and the
``aggregate`` kernel's plain version against the reference's Pallas
kernel (interpret mode, at the shapes of ``tests/test_kernels.py``).

Departure (a): the port's ``ssfl`` calls ``aggregate(use_pallas=True)``,
so the split stack goes through ``aggregate_leaf``; the reference's
``ssfl`` omits the flag and takes its jnp ``_agg_leaf`` path. The last
test holds the port's kernel path to that reference path. Tolerance 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import aggregation as JAGG  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.kernels.layer_aggregate import ops as JAO  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import aggregation as TAGG  # noqa: E402
from repro_torch.kernels.layer_aggregate import ops as TAO  # noqa: E402
from repro_torch.kernels.layer_aggregate import ref as TAR  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,Lk,rest", [(3, 2, (40,)), (5, 4, (3, 90)),
                                       (2, 6, (512,)), (8, 3, (7, 11, 5))])
def test_aggregate_plain_version_matches_pallas_kernel(N, Lk, rest):
    rng = np.random.default_rng(42)
    c = rng.normal(size=(N, Lk) + rest).astype(np.float32)
    ww = rng.uniform(0, 1, (N, Lk)).astype(np.float32)
    ww[0, Lk // 2:] = 0.0
    s = rng.normal(size=(Lk,) + rest).astype(np.float32)
    want = np.asarray(JAO.aggregate_leaf(jnp.asarray(c), jnp.asarray(ww),
                                         jnp.asarray(s), 0.01))
    before = TAO.aggregate_leaf.launches
    got = TAO.aggregate_leaf(torch.tensor(c), torch.tensor(ww),
                             torch.tensor(s), 0.01)
    assert TAO.aggregate_leaf.launches == before   # CPU: plain version
    assert tuple(got.shape) == s.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    F = int(np.prod(rest))
    np.testing.assert_array_equal(
        got.numpy(), TAR.aggregate(torch.tensor(c).reshape(N, Lk, F),
                                   torch.tensor(ww),
                                   torch.tensor(s).reshape(Lk, F),
                                   0.01).reshape(s.shape).numpy())


@pytest.mark.parametrize("N,Lk,rest", [(3, 2, (40,)), (8, 3, (7, 11, 5))])
def test_aggregate_numerator_plain_version_matches_pallas_kernel(N, Lk, rest):
    """The numerator mode's plain version (a fleet mesh's ranks sum their
    own rows with it before one all-reduce): with s = 0 the reference
    kernel returns num / (den + lam), so num is its output times
    (den + lam)."""
    rng = np.random.default_rng(7)
    c = rng.normal(size=(N, Lk) + rest).astype(np.float32)
    ww = rng.uniform(0, 1, (N, Lk)).astype(np.float32)
    s = np.zeros((Lk,) + rest, np.float32)
    out = np.asarray(JAO.aggregate_leaf(jnp.asarray(c), jnp.asarray(ww),
                                        jnp.asarray(s), 0.01))
    scale = (ww.sum(0) + 0.01).reshape((Lk,) + (1,) * len(rest))
    before = TAO.aggregate_numerator.launches
    got = TAO.aggregate_numerator(torch.tensor(c), torch.tensor(ww))
    assert TAO.aggregate_numerator.launches == before   # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == s.shape
    np.testing.assert_allclose(got.numpy(), out * scale, **TOL)


def test_aggregate_all_zero_weights_returns_server_value():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(3, 2, 128)).astype(np.float32)
    s = rng.normal(size=(2, 128)).astype(np.float32)
    ww = np.zeros((3, 2), np.float32)
    want = np.asarray(JAO.aggregate_leaf(jnp.asarray(c), jnp.asarray(ww),
                                         jnp.asarray(s), 0.01))
    got = TAO.aggregate_leaf(torch.tensor(c), torch.tensor(ww),
                             torch.tensor(s), 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, s, rtol=1e-5)
    # (0 + lam*s) / (0 + lam) is s to within one ulp
    assert np.all(np.abs(got - s) <= np.spacing(np.abs(s)))


@pytest.mark.parametrize("masked", [False, True])
def test_client_weights_and_presence(masked):
    rng = np.random.default_rng(3)
    depths = np.array([1, 3, 2, 3, 1], np.int32)
    losses = rng.uniform(0.5, 2.5, 5).astype(np.float32)
    mask = np.array([True, False, True, True, False]) if masked else None
    want = JAGG.client_weights(depths, losses, 1e-8, mask=mask)
    got = TAGG.client_weights(depths, torch.tensor(losses), 1e-8, mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(TAGG.presence_mask(depths, 4).numpy(),
                                  np.asarray(JAGG.presence_mask(depths, 4)))


def _stacked_round(seed):
    """A reduced ViT global tree plus a full-fleet client stack zero beyond
    each client's depth, losses and a trained mask, as numpy."""
    jcfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    depths = np.array([1, 3, 2, 3, 2, 1], np.int32)
    client = JSN.split_params(jcfg, params, None)[0]

    def stack(path, x):
        out = rng.normal(size=(6,) + x.shape).astype(np.float32) * 0.1 + x
        if path[0].key == "layers":
            for i, d in enumerate(depths):
                out[i, d:] = 0.0
        return out

    stacks = jax.tree_util.tree_map_with_path(stack, client)
    losses = rng.uniform(0.8, 2.0, 6).astype(np.float32)
    mask = np.array([True, True, False, True, True, True])
    return jcfg, params, stacks, depths, losses, mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_matches_reference_plain_path(seed, use_pallas):
    """Departure (a): with ``use_pallas=True`` the port's split stack goes
    through the kernel's wrapper; it must equal the reference's jnp path,
    which its ``ssfl`` takes."""
    jcfg, params, stacks, depths, losses, mask = _stacked_round(seed)
    tcfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    want, wj = JAGG.aggregate(jcfg, jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, stacks), depths,
                              jnp.asarray(losses), mask=mask)
    got, wt = TAGG.aggregate(tcfg, bridge.to_torch(params, device="cpu"),
                             bridge.to_torch(stacks, device="cpu"), depths,
                             torch.tensor(losses), mask=mask,
                             use_pallas=use_pallas)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    want_flat = {tuple(k.key for k in p): np.asarray(x) for p, x in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    got_flat = {p: x.numpy() for p, x in tree_flatten_with_path(got)}
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        np.testing.assert_allclose(got_flat[k], v, err_msg=str(k), **TOL)
