"""Parity of the port's host-side modules with the JAX package: configs,
synthetic data and the batch stream, Eq. 1 allocation and the fleet,
availability draws, optimizers, and the supernet split views.

Inputs come from numpy seeds and go through both packages; weights cross
through ``repro_torch.bridge``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import allocation as JAL  # noqa: E402
from repro.core import fault as JF  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.federated import simulator as JSIM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro import optim as JO  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import allocation as TAL  # noqa: E402
from repro_torch.core import fault as TF  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.federated import simulator as TSIM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)


def _cfgs():
    return (JB.get_reduced("vit16_cifar").replace(**SMALL),
            TB.get_reduced("vit16_cifar").replace(**SMALL))


def _flat_np(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {p: x.detach().cpu().numpy() for p, x in
            tree_flatten_with_path(tree)}


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_vit_config_fields_match(which):
    j = JB.get_config("vit16_cifar") if which == "CONFIG" \
        else JB.get_reduced("vit16_cifar")
    t = TB.get_config("vit16_cifar") if which == "CONFIG" \
        else TB.get_reduced("vit16_cifar")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_split_depth == j.resolved_split_depth
    assert t.split_stack_len == j.split_stack_len


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 3])
def test_federated_data_and_batch_stream_match(seed):
    kw = dict(n_classes=6, image_size=8, samples=512, alpha=0.5, seed=seed)
    jd = JD.make_federated_data(5, **kw)
    td = TD.make_federated_data(5, **kw)
    for a, b in zip(jd["clients"], td["clients"]):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(jd["test"].images, td["test"].images)
    np.testing.assert_array_equal(jd["test"].labels, td["test"].labels)
    jdd = JD.DeviceData(jd["clients"])
    tdd = TD.DeviceData(td["clients"], "cpu")
    np.testing.assert_array_equal(np.asarray(jdd.images),
                                  tdd.images.numpy())
    np.testing.assert_array_equal(np.asarray(jdd.labels),
                                  tdd.labels.numpy())
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for ids in ([0, 2, 4], [1], [3, 0]):
        np.testing.assert_array_equal(
            jdd.sample_indices(ids, 3, 7, ra),
            tdd.sample_indices(ids, 3, 7, rb))


# ------------------------------------------------------- allocation + fleet

@pytest.mark.parametrize("seed", range(6))
def test_eq1_depths_match(seed):
    rng = np.random.default_rng(seed)
    n = 40
    mem = rng.uniform(2.0, 16.0, n)
    lat = rng.uniform(20.0, 200.0, n)
    # values that land exactly on a floor boundary in float32
    mem[:4] = [2.0, 4.0, 6.0, 15.999999]
    for L in (4, 12):
        np.testing.assert_array_equal(
            np.asarray(JAL.allocate_depths(mem, lat, L)),
            TAL.allocate_depths(mem, lat, L))


@pytest.mark.parametrize("n,seed", [(6, 0), (8, 0), (17, 5), (64, 2)])
def test_fleet_matches(n, seed):
    jcfg, tcfg = _cfgs()
    for L in (4, 12):
        jf = JSIM.make_fleet(jcfg.replace(n_layers=L), n, seed=seed)
        tf = TSIM.make_fleet(tcfg.replace(n_layers=L), n, seed=seed)
        np.testing.assert_array_equal(jf.depths, tf.depths)
        np.testing.assert_array_equal(jf.capacity, tf.capacity)
        np.testing.assert_array_equal(jf.feasible, tf.feasible)
        assert {d: ids.tolist() for d, ids in jf.cohorts().items()} == \
            {d: ids.tolist() for d, ids in tf.cohorts().items()}


@pytest.mark.parametrize("fraction", [0.0, 0.3, 0.8, 1.0])
def test_availability_draws_match(fraction):
    ja = JF.AvailabilityModel(fraction, seed=7)
    ta = TF.AvailabilityModel(fraction, seed=7)
    for n in (6, 6, 11, 1):
        np.testing.assert_array_equal(ja.draw(n), ta.draw(n))


def test_arrival_state_payloads_cross_packages():
    """``get_state`` gives the reference's JSON-able payload, and a payload
    from either package rewinds the other's stream."""
    ja = JF.AvailabilityModel(0.6, seed=7)
    ta = TF.AvailabilityModel(0.6, seed=7)
    for src, dst in ((ja, ta), (ta, ja)):
        src.draw(5)
        state = json.loads(json.dumps(src.get_state()))
        assert state == src.get_state()
        dst.set_state(state)
        assert dst.get_state() == src.get_state()
        np.testing.assert_array_equal(dst.draw(9), src.draw(9))


# ---------------------------------------------------------------- optimizers

def _tree_np(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 5)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd_momentum", {}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1}),
                                     ("fedadam", {}), ("fedyogi", {})])
def test_optimizer_steps_match(name, kw):
    jopt = JO.get_optimizer(name, 0.05, **kw)
    topt = TO.get_optimizer(name, 0.05, **kw)
    assert topt is TO.get_optimizer(name, 0.05, **kw)
    jp = jax.tree.map(jnp.asarray, _tree_np(0))
    tp = bridge.to_torch(_tree_np(0), device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree_np(10 + step)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(bridge.to_torch(g, device="cpu"), ts, tp)
        jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
    want, got = _flat_np(jp), _flat_t(tp)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    if name in ("fedadam", "fedyogi"):
        # two fp32 moment entries, no bookkeeping: the reference's slots
        assert sorted(ts) == sorted(js) == ["m", "v"]
        for k in ("m", "v"):
            for path, x in _flat_np(js[k]).items():
                np.testing.assert_allclose(_flat_t(ts[k])[path], x,
                                           rtol=1e-6, atol=1e-7)
    if name == "adamw":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 3
        sl = TO.map_moments(lambda t: tree_map(lambda x: x[:1], t), ts, tp)
        assert sl["t"] is ts["t"] and sl["m"]["a"].shape == (1, 4)


def test_tree_bytes_matches():
    from repro.federated import metrics as JMET
    from repro_torch.federated import metrics as TMET
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    assert TMET.tree_bytes(tp) == JMET.tree_bytes(jp) > 0


# ------------------------------------------------------------------ supernet

@pytest.mark.parametrize("d", [1, 2, 3])
def test_split_merge_and_bytes_match(d):
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    for jv, tv in zip(JSN.split_params(jcfg, jp, d),
                      TSN.split_params(tcfg, tp, d)):
        want, got = _flat_np(jv), _flat_t(tv)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    merged = TSN.merge_params(tcfg, *TSN.split_params(tcfg, tp, d))
    full = _flat_t(tp)
    for k, v in _flat_t(merged).items():
        np.testing.assert_array_equal(v, full[k])
    assert TSN.client_param_bytes(tcfg, tp, d) == \
        JSN.client_param_bytes(jcfg, jp, d)
