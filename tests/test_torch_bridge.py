"""The bridge: a reduced ViT tree crosses numpy -> torch -> numpy unchanged,
the port's ``init_params`` has the reference's keys, shapes and dtypes, and
``install_weights`` refuses a tree that does not match."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.federated.state import init_train_state  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated.state import (  # noqa: E402
    init_train_state as t_init_train_state)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)


def _flat_np(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    cfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    return JM.init_params(cfg, jax.random.PRNGKey(0))


def test_tree_round_trips_unchanged(jax_params):
    np_tree = jax.tree.map(np.asarray, jax_params)
    back = bridge.to_numpy(bridge.to_torch(np_tree, device="cpu"))
    want, got = _flat_np(np_tree), _flat_np(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_bf16_leaves_cross_exactly(jax_params):
    np_tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                           jax_params)
    t = bridge.to_torch(np_tree, device="cpu")
    assert t["layers"]["attn"]["wq"].dtype == torch.float32
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(
        back["pos_embed"], np.asarray(jax_params["pos_embed"]
                                      .astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_params_has_reference_keys_shapes_dtypes(dtype):
    jcfg = JB.get_reduced("vit16_cifar").replace(dtype=dtype, **SMALL)
    tcfg = TB.get_reduced("vit16_cifar").replace(dtype=dtype, **SMALL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1),
                        device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat_np(jp).items()}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_flatten_with_path(tp)}
    assert got == want
    # same distributions: N(0, 0.02^2) weights, zero biases, unit scales
    w = tp["layers"]["attn"]["wq"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert float(tp["layers"]["mlp"]["b_up"].abs().max()) == 0.0
    assert float((tp["layers"]["attn_norm_scale"] - 1).abs().max()) == 0.0


def test_install_weights_into_state_and_refuses_mismatch(jax_params):
    jcfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    tcfg = TB.get_reduced("vit16_cifar").replace(**SMALL)
    js = init_train_state(jcfg, 3, seed=0)
    ts = t_init_train_state(tcfg, 3, seed=0, device="cpu")
    P = jax.tree.map(np.asarray, js.params)
    H = jax.tree.map(np.asarray, js.local_heads)
    bridge.install_weights(ts, P, H)
    for k, v in _flat_np(H).items():
        got = {p: x for p, x in tree_flatten_with_path(ts.local_heads)}[k]
        np.testing.assert_array_equal(got.numpy(), v)
    # the engine never writes through into the caller's arrays
    ts.local_heads["local_head"].zero_()
    assert np.abs(H["local_head"]).max() > 0
    bad = dict(P)
    bad["head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatches"):
        bridge.install_weights(ts, bad, H)
    missing = {k: v for k, v in P.items() if k != "pos_embed"}
    with pytest.raises(ValueError, match="missing"):
        bridge.install_weights(ts, missing, H)
