"""The width supernet in the port against the JAX package: the sliced
config and plan, the four width views, width-sliced splits and their
byte and parameter counts, the width ladder, the workspace scatter, the
per-coordinate Eq. 8 denominators and width-sliced TPGF.

Inputs come from numpy seeds and go through both packages; weights cross
through ``repro_torch.bridge``. Tolerances: the views, counts and masks
exactly; ``aggregate(widths=)`` within 1e-6 (einsum sums in another
order); width-0.5 ``tpgf_grads_split`` within 1e-5 (fp32 forward and
backward). Two configs: the reduced ViT with ``n_kv_heads == n_heads``
and a GQA one with two query heads per KV head.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import aggregation as JAGG  # noqa: E402
from repro.core import allocation as JAL  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.federated import simulator as JSIM  # noqa: E402
from repro.federated.strategies import base as JBASE  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import aggregation as TAGG  # noqa: E402
from repro_torch.core import allocation as TAL  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.federated import simulator as TSIM  # noqa: E402
from repro_torch.federated.strategies import base as TBASE  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,  # noqa: E402
                              tree_map)

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
GQA = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
           d_ff=64, image_size=16, n_classes=6)
LADDER = (0.25, 0.5, 0.75, 1.0)
NARROW = (0.25, 0.5, 0.75)


def _cfgs(kw):
    return (JB.get_reduced("vit16_cifar").replace(**kw),
            TB.get_reduced("vit16_cifar").replace(**kw))


def _flat_j(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {p: x.detach().numpy() for p, x in tree_flatten_with_path(tree)}


def _assert_trees_equal(got, want, **tol):
    got, want = _flat_t(got), _flat_j(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if tol:
            np.testing.assert_allclose(got[k], w, err_msg=str(k), **tol)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


@pytest.fixture(scope="module", params=["small", "gqa"])
def model(request):
    """(jcfg, tcfg, jax params, torch params) with random non-zero
    weights (numpy noise on top of the reference's init)."""
    jcfg, tcfg = _cfgs(SMALL if request.param == "small" else GQA)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(7)
    np_p = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_p),
            bridge.to_torch(np_p, device="cpu"))


# ------------------------------------------------------- config and plan

@pytest.mark.parametrize("width", LADDER)
@pytest.mark.parametrize("which", ["vit16_cifar", "gqa"])
def test_width_cfg_and_plan_match(which, width):
    if which == "vit16_cifar":
        jcfg, tcfg = (JB.get_config("vit16_cifar"),
                      TB.get_config("vit16_cifar"))
    else:
        jcfg, tcfg = _cfgs(GQA)
    jw, tw = JSN.width_cfg(jcfg, width), TSN.width_cfg(tcfg, width)
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
    assert tw.resolved_head_dim == tcfg.resolved_head_dim
    assert tw.n_heads == (tcfg.n_heads // tcfg.n_kv_heads) * tw.n_kv_heads
    assert TSN.width_plan(tcfg, width) == JSN.width_plan(jcfg, width)
    assert TSN.width_keep_sizes(tcfg, width) == \
        JSN.width_keep_sizes(jcfg, width)
    if width == 1.0:
        assert tw is tcfg


# ------------------------------------------------------------ the views

@pytest.mark.parametrize("width", NARROW)
def test_width_views_match(model, width):
    jcfg, tcfg, jp, tp = model
    jfull = JSN.split_params(jcfg, jp, None)[0]
    tfull = TSN.split_params(tcfg, tp, None)[0]
    jsl = JSN.slice_width(jcfg, jfull, width)
    tsl = TSN.slice_width(tcfg, tfull, width)
    _assert_trees_equal(tsl, jsl)
    jmask = JSN.mask_width(jcfg, jfull, width)
    _assert_trees_equal(TSN.mask_width(tcfg, tfull, width), jmask)
    # widen(slice(t)) == mask(t), in both packages
    _assert_trees_equal(TSN.widen_width(tcfg, tsl, width), jmask)
    # scatter a fresh sliced tree into the full one: only kept coordinates
    rng = np.random.default_rng(3)
    new_np = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), jsl)
    want = JSN.scatter_width(jcfg, jfull, jax.tree.map(jnp.asarray, new_np),
                             width)
    before = {k: v.copy() for k, v in _flat_t(tfull).items()}
    got = TSN.scatter_width(tcfg, tfull,
                            bridge.to_torch(new_np, device="cpu"), width)
    _assert_trees_equal(got, want)
    for k, v in _flat_t(tfull).items():        # the input is not written
        np.testing.assert_array_equal(v, before[k])


def test_views_are_identities_at_full_width(model):
    _, tcfg, _, tp = model
    client = TSN.split_params(tcfg, tp, 2)[0]
    assert TSN.slice_width(tcfg, client, 1.0) is client
    assert TSN.mask_width(tcfg, client, 1.0) is client
    assert TSN.widen_width(tcfg, client, 1.0) is client
    assert TSN.scatter_width(tcfg, client, client, 1.0) is client
    for a, b in zip(tree_leaves(TSN.split_params(tcfg, tp, 2)),
                    tree_leaves(TSN.split_params(tcfg, tp, 2, 1.0))):
        assert a.shape == b.shape and a.data_ptr() == b.data_ptr()


@pytest.mark.parametrize("width", LADDER)
@pytest.mark.parametrize("d", [1, 2])
def test_split_params_bytes_and_counts_match(model, d, width):
    """``width`` slices the client stack only; the server suffix and the
    local head stay full width."""
    jcfg, tcfg, jp, tp = model
    for jv, tv in zip(JSN.split_params(jcfg, jp, d, width),
                      TSN.split_params(tcfg, tp, d, width)):
        _assert_trees_equal(tv, jv)
    assert TSN.client_param_bytes(tcfg, tp, d, width) == \
        JSN.client_param_bytes(jcfg, jp, d, width)
    assert TBASE.split_param_counts(tcfg, tp, d, width) == \
        JBASE.split_param_counts(jcfg, jp, d, width)


# ------------------------------------------------------- ladder and fleet

@pytest.mark.parametrize("tiers", [LADDER, (0.5, 1.0), (1.0,),
                                   (1.0, 0.25, 0.5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocate_widths_and_fleet_match(seed, tiers):
    mem = np.random.default_rng(seed).uniform(0.0, 18.0, 40)
    got = TAL.allocate_widths(mem, tiers)
    np.testing.assert_array_equal(got, JAL.allocate_widths(mem, tiers))
    assert got.dtype == np.float64
    cfg_j, cfg_t = _cfgs(SMALL)
    fj = JSIM.make_fleet(cfg_j, 9, seed=seed)
    ft = TSIM.make_fleet(cfg_t, 9, seed=seed)
    np.testing.assert_array_equal(ft.widths, fj.widths)
    assert ft.widths.dtype == fj.widths.dtype
    with pytest.raises(ValueError):
        TAL.allocate_widths(mem, (0.0, 1.0))


# --------------------------------------------------- workspace scatter

@pytest.mark.parametrize("width", NARROW)
def test_scatter_client_rows_writes_zeros_beyond_the_slice(model, width):
    """The workspace is written in place, so its pruned channels and rows
    ``[d:]`` must be written as zeros over whatever a row held before:
    the row then equals the reference's zero-padded ``widen_width``."""
    jcfg, tcfg, jp, tp = model
    d = 2
    ws = {"client_stack": tree_map(
        lambda x: torch.full((3,) + tuple(x.shape), 7.0),
        TSN.split_params(tcfg, tp, None)[0])}
    client = TSN.split_params(tcfg, tp, d, width)[0]
    TBASE.scatter_client_rows(tcfg, ws, [1], [client], d, width)
    wide = JSN.widen_width(jcfg, JSN.split_params(jcfg, jp, d, width)[0],
                           width)
    row = {p: x[1].numpy() for p, x in tree_flatten_with_path(
        ws["client_stack"])}
    for k, want in _flat_j(wide).items():
        if k[0] == "layers":
            np.testing.assert_array_equal(row[k][:d], want, err_msg=str(k))
            assert not row[k][d:].any(), k
        else:
            np.testing.assert_array_equal(row[k], want, err_msg=str(k))


# ------------------------------------------------ width-aware Eq. 8

@pytest.mark.parametrize("widths", [LADDER, (0.5, 1.0), (0.25, 0.75)])
def test_width_coord_masks_match(model, widths):
    jcfg, tcfg, _, _ = model
    want = JAGG.width_coord_masks(jcfg, widths)
    got = TAGG.width_coord_masks(tcfg, widths)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def _width_round(jcfg, params, seed):
    """A trained round's workspace: 6 clients at mixed depths and widths,
    each row zero beyond its depth and its width slice."""
    rng = np.random.default_rng(seed)
    depths = np.array([1, 2, 3, 3, 2, 1])
    widths = np.array([0.25, 0.5, 1.0, 0.75, 0.25, 1.0])
    client = JSN.split_params(jcfg, params, None)[0]
    plan = JSN.width_plan(jcfg, 1.0)

    def stack(path, x):
        out = rng.normal(size=(6,) + x.shape).astype(np.float32) * 0.1 + x
        if path[0].key == "layers":
            name = JSN._leaf_name(path)
            for i, (d, w) in enumerate(zip(depths, widths)):
                out[i, d:] = 0.0
                if name in plan:
                    ax, _ = plan[name]
                    keep = JSN.width_keep_sizes(jcfg, w)[name]
                    idx = [slice(None)] * out.ndim
                    idx[0] = i
                    idx[out.ndim + ax] = slice(keep, None)
                    out[tuple(idx)] = 0.0
        return out

    stacks = jax.tree_util.tree_map_with_path(stack, client)
    losses = rng.uniform(0.8, 2.0, 6).astype(np.float32)
    mask = np.array([True, True, False, True, True, True])
    return stacks, depths, widths, losses, mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_with_widths_matches(model, seed, use_pallas):
    """Departure (a) extended: under ``use_pallas`` the port sends the
    non-plan stack leaves through the ``aggregate`` kernel's wrapper; the
    reference takes plain einsums for every leaf."""
    jcfg, tcfg, jp, tp = model
    params = jax.tree.map(np.asarray, jp)
    stacks, depths, widths, losses, mask = _width_round(jcfg, params, seed)
    want, wj = JAGG.aggregate(jcfg, jp, jax.tree.map(jnp.asarray, stacks),
                              depths, jnp.asarray(losses), mask=mask,
                              widths=widths)
    got, wt = TAGG.aggregate(tcfg, tp, bridge.to_torch(stacks, device="cpu"),
                             depths,
                             torch.tensor(losses), mask=mask,
                             use_pallas=use_pallas, widths=widths)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-6)
    _assert_trees_equal(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------ width-sliced TPGF

_JAX_TPGF = {}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("avail", [True, False])
def test_tpgf_grads_split_at_width_half(model, avail, use_pallas):
    """The client forward runs on the width-0.5 slice; the local head and
    the server suffix stay full width. d = 2, static on both sides."""
    jcfg, tcfg, jp, tp = model
    d, width = 2, 0.5
    rng = np.random.default_rng(11)
    images = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 6, 4)
    jb = {"images": jnp.asarray(images),
          "label": jnp.asarray(labels.astype(np.int32))}
    tb = {"images": torch.tensor(images),
          "label": torch.tensor(labels.astype(np.int64))}
    key = (jcfg, avail)
    if key not in _JAX_TPGF:   # one reference per use_pallas pair
        _JAX_TPGF[key] = JT.tpgf_grads_split(
            jcfg, JSN.width_cfg(jcfg, width),
            *JSN.split_params(jcfg, jp, d, width), jb, d,
            server_available=avail)
    jo = _JAX_TPGF[key]
    tcfg = tcfg.replace(use_pallas=use_pallas)
    to = TT.tpgf_grads_split(tcfg, TSN.width_cfg(tcfg, width),
                             *TSN.split_params(tcfg, tp, d, width), tb, d,
                             server_available=avail)
    for name in ("loss_client", "loss_server", "w_client"):
        np.testing.assert_allclose(float(getattr(to, name)),
                                   float(getattr(jo, name)), rtol=1e-5,
                                   atol=1e-5)
    for name in ("g_client", "g_server", "g_local"):
        _assert_trees_equal(getattr(to, name), getattr(jo, name),
                            rtol=1e-5, atol=1e-5)
