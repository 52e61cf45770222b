"""Checkpoints in the port: the reference's npz + json format, the
manifest's validation, the per-index heads of older checkpoints,
bit-identical resume, every stream surviving it, and checkpoints crossing
between the two packages.

Held: a resumed run (1 round, ``save``, a fresh engine, ``restore``, the
rest) equals the uninterrupted one bit for bit — params, local heads and
``opt_state`` — for ``ssfl``/``adamw``, ``sfl``/``adamw``, ``fedavgm``,
``fedadam`` and ``fedyogi``. Across the packages (``sfl``/``adamw`` at the
``tests/_torch_parity.py`` setting), a checkpoint written by either after
round 1 restores in the other, whose round 2 then matches
the writer's uninterrupted round 2 at the parity limits (loss 1e-5,
params, heads and moments 1e-4) and its streams exactly.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from _torch_parity import ARGS, SMALL, flat_jax  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (FORMAT_VERSION, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core.fault import AvailabilityModel  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402



def _cfg():
    return TB.get_reduced("vit16_cifar").replace(**SMALL)


def _engine(strategy="ssfl", n_clients=6, **kw):
    args = dict(ARGS, **kw)
    return TEngine(_cfg(), n_clients, strategy, device="cpu", **args)


def _flat(tree):
    return {p: x for p, x in tree_flatten_with_path(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def _flat_np(tree):
    """A nested tree of arrays or tensors -> {path: numpy}."""
    out = {}
    for p, x in tree_flatten_with_path(tree):
        out[p] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


# ---------------------------------------------------------------- format

def _sample_tree():
    g = torch.Generator().manual_seed(3)
    return {"params": {"w": torch.randn((3, 4), generator=g),
                       "layers": {"b": torch.randn((2, 5), generator=g)}},
            "opt_state": {"server": {"t": torch.tensor(7, dtype=torch.int32),
                                     "m": [torch.ones(2), torch.zeros(1)]},
                          "empty": ()},
            "count": np.int64(5)}


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
def test_format_round_trip(tmp_path, writer, reader):
    tree = _sample_tree()
    path = str(tmp_path / "sub" / "ck")
    meta = {"batch_rng": np.random.default_rng(1).bit_generator.state}
    if writer == "port":
        save_checkpoint(path, tree, step=4, meta=meta)
    else:
        j_save(path, jax.tree.map(np.asarray, bridge.to_numpy(
            {k: v for k, v in tree.items() if k != "count"})
            | {"count": tree["count"]}), step=4, meta=meta)
    loaded, manifest = (load_checkpoint if reader == "port"
                        else j_load)(path)
    want = _flat_np(tree)
    want = {"/".join(map(str, p)): v for p, v in want.items()}
    assert manifest["format"] == FORMAT_VERSION == 1
    assert manifest["step"] == 4 and manifest["meta"] == json.loads(
        json.dumps(meta))
    assert manifest["keys"] == sorted(want)
    got = {"/".join(p): v for p, v in _flat_np(loaded).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert manifest["dtypes"][k] == str(v.dtype)
        assert manifest["shapes"][k] == list(v.shape)
        np.testing.assert_array_equal(got[k], v)


def _truncate(path):
    """Drop one array from the npz, keeping the manifest."""
    with np.load(path + ".npz") as data:
        kept = {k: data[k] for k in data.files if k != "params/w"}
    np.savez(path + ".npz", **kept)


def _reshape(path):
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    arrays["params/w"] = arrays["params/w"].reshape(4, 3)
    np.savez(path + ".npz", **arrays)


@pytest.mark.parametrize("damage,match", [(_truncate, "absent from the npz"),
                                          (_reshape, "manifest says")])
def test_manifest_validation_errors(tmp_path, damage, match):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _sample_tree())
    damage(path)
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A bf16 leaf (beside an fp32 one) written by either package reads
    back in the other bit for bit: raw 2-byte words in the npz,
    ``"bfloat16"`` in the manifest."""
    path = str(tmp_path / "ck")
    g = torch.Generator().manual_seed(5)
    w = torch.randn((3, 5), generator=g).bfloat16()
    w[0, :3] = torch.tensor([float("inf"), -0.0, 2.0 ** -130])
    b = torch.randn(4, generator=g)
    words = w.view(torch.int16).numpy()
    if writer == "port":
        save_checkpoint(path, {"params": {"w": w, "b": b}}, step=3)
        tree, manifest = j_load(path)
        assert np.asarray(tree["params"]["w"]).view(np.int16).tolist() \
            == words.tolist()
    else:
        j_save(path, {"params": {"w": jnp.asarray(words).view(jnp.bfloat16),
                                 "b": jnp.asarray(b.numpy())}}, step=3)
        tree, manifest = load_checkpoint(path)
        got = tree["params"]["w"]
        assert got.dtype == torch.bfloat16 and got.shape == (3, 5)
        assert torch.equal(got.view(torch.int16), w.view(torch.int16))
    assert manifest["dtypes"] == {"params/w": "bfloat16",
                                  "params/b": "float32"}
    assert manifest["step"] == 3 and manifest["shapes"]["params/w"] == [3, 5]
    np.testing.assert_array_equal(np.asarray(tree["params"]["b"]),
                                  b.numpy())


# ------------------------------------------------------------ the engine

def test_train_state_round_trip_keeps_devices_and_dtypes(tmp_path):
    eng = _engine(n_clients=3, local_steps=1)
    eng.run_round()
    path = str(tmp_path / "state")
    eng.state.save(path)
    other = _engine(n_clients=3, local_steps=1, seed=4)
    other.state.restore(path)
    assert other.state.round_idx == 1
    _assert_trees_equal(eng.state.params, other.state.params)
    _assert_trees_equal(eng.state.local_heads, other.state.local_heads)
    assert other.state.rng.bit_generator.state == \
        eng.state.rng.bit_generator.state
    wrong = _engine(n_clients=4, local_steps=1)
    with pytest.raises(ValueError, match="local_heads"):
        wrong.state.restore(path)


def test_engine_restores_a_legacy_per_index_checkpoint(tmp_path):
    """A checkpoint in the per-index layout (``local_heads/<i>/...``, 11
    clients so two-digit keys occur) restores through ``Engine.restore``
    and continues bit for bit."""
    mk = lambda: _engine(n_clients=11, local_steps=1, optimizer="adamw",
                         lr=0.01, availability=0.7)
    a = mk()
    a.run_round()
    a.run_round()
    b = mk()
    b.run_round()
    b.save(str(tmp_path / "modern"))
    tree, manifest = load_checkpoint(str(tmp_path / "modern"))
    tree["local_heads"] = {str(i): tree_map(lambda x, i=i: x[i],
                                            tree["local_heads"])
                           for i in range(11)}
    save_checkpoint(str(tmp_path / "legacy"), tree, step=manifest["step"],
                    meta=manifest["meta"])
    c = mk()
    c.restore(str(tmp_path / "legacy"))
    assert c.state.round_idx == 1
    c.run_round()
    _assert_trees_equal(a.state.params, c.state.params)
    _assert_trees_equal(a.state.local_heads, c.state.local_heads)


RESUME_CASES = {
    "ssfl-adamw": dict(strategy="ssfl", optimizer="adamw", lr=0.01,
                       availability=0.7, sample_frac=0.8),
    "sfl-adamw": dict(strategy="sfl", optimizer="adamw", lr=0.01),
    "fedavgm": dict(strategy="fedavgm", sample_frac=0.8),
    "fedadam": dict(strategy="fedadam", sample_frac=0.8),
    "fedyogi": dict(strategy="fedyogi", sample_frac=0.8),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bit_identical(tmp_path, case):
    """2 uninterrupted rounds == 1 round + save + a fresh engine +
    restore + 1 round, bit for bit: params, heads and opt_state."""
    mk = lambda: _engine(**RESUME_CASES[case])
    a = mk()
    a.run_round()
    a.run_round()
    b = mk()
    b.run_round()
    b.save(str(tmp_path / "ck"))
    c = mk()
    c.restore(str(tmp_path / "ck"))
    assert c.state.round_idx == 1 and c._server_opt_ok is None
    rec = c.run_round()
    assert rec["round"] == 2 and rec["loss"] == a.history[-1]["loss"]
    _assert_trees_equal(a.state.params, c.state.params)
    _assert_trees_equal(a.state.local_heads, c.state.local_heads)
    assert "server" in a.state.opt_state
    _assert_trees_equal(a.state.opt_state, c.state.opt_state)


def test_every_stream_survives_resume(tmp_path):
    """A setting that draws from every stream each round — batches,
    availability, sampling, participation — plus the staleness and
    server-update counters resumes bit for bit."""
    mk = lambda: _engine("ssfl", availability=0.8, sample_frac=0.5,
                         participation=AvailabilityModel(0.9, seed=21))
    a = mk()
    for _ in range(3):
        a.run_round()
    b = mk()
    b.run_round()
    b.save(str(tmp_path / "ck"))
    c = mk()
    c.restore(str(tmp_path / "ck"))
    assert c.state.rng.bit_generator.state == \
        b.state.rng.bit_generator.state
    assert c._sample_rng.bit_generator.state == \
        b._sample_rng.bit_generator.state
    assert c.avail_model.get_state() == b.avail_model.get_state()
    assert c.participation.get_state() == b.participation.get_state()
    np.testing.assert_array_equal(c._staleness, b._staleness)
    assert b._staleness.any()
    assert c._server_updates == b._server_updates == 1
    c.run_round()
    c.run_round()
    assert [r["loss"] for r in a.history[1:]] == \
        [r["loss"] for r in c.history]
    _assert_trees_equal(a.state.params, c.state.params)
    _assert_trees_equal(a.state.local_heads, c.state.local_heads)


# ----------------------------------------------------- across the packages

# sfl with adamw: every part of the state crosses — params, stacked heads,
# and server moments with an int32 step count
CROSS = dict(optimizer="adamw", lr=0.01)
CROSS_STRATEGY = "sfl"


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Each package writes a checkpoint after round 1 of the same run (the
    port from the reference's weights), goes on to round 2, and the other
    package restores that checkpoint and runs round 2."""
    tmp = tmp_path_factory.mktemp("cross")
    jcfg = JB.get_reduced("vit16_cifar").replace(**SMALL)
    args = dict(ARGS, **CROSS)
    ref = JEngine(jcfg, 6, CROSS_STRATEGY, **args)
    weights = (jax.tree.map(np.asarray, ref.state.params),
               jax.tree.map(np.asarray, ref.state.local_heads))
    port = _engine(CROSS_STRATEGY, **CROSS)
    bridge.install_weights(port, *weights)
    out = {}
    for name, eng in (("reference", ref), ("port", port)):
        eng.run_round()
        eng.save(str(tmp / name))
        out[name] = {"round2": eng.run_round(), "engine": eng}
    # the reader restores the other package's checkpoint
    j_reader = JEngine(jcfg, 6, CROSS_STRATEGY, **args)
    j_reader.restore(str(tmp / "port"))
    t_reader = _engine(CROSS_STRATEGY, **CROSS)
    t_reader.restore(str(tmp / "reference"))
    out["reference"]["reader"] = ("port", t_reader, t_reader.run_round())
    out["port"]["reader"] = ("reference", j_reader, j_reader.run_round())
    return out


def _state_np(eng):
    s = eng.state
    if isinstance(eng, TEngine):
        return {k: _flat_np(getattr(s, k))
                for k in ("params", "local_heads", "opt_state")}
    return {k: flat_jax(getattr(s, k))
            for k in ("params", "local_heads", "opt_state")}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(crossed, writer):
    run = crossed[writer]
    _, reader, rec = run["reader"]
    want_rec, writer_eng = run["round2"], run["engine"]
    assert rec["round"] == want_rec["round"] == 2
    assert rec["loss"] == pytest.approx(want_rec["loss"], abs=1e-5)
    # the streams went across exactly: both sit at the same positions
    assert reader.state.rng.bit_generator.state == \
        writer_eng.state.rng.bit_generator.state
    assert reader._sample_rng.bit_generator.state == \
        writer_eng._sample_rng.bit_generator.state
    assert reader.avail_model.get_state() == writer_eng.avail_model.get_state()
    np.testing.assert_array_equal(reader._staleness, writer_eng._staleness)
    assert reader._server_updates == writer_eng._server_updates
    got, want = _state_np(reader), _state_np(writer_eng)
    for part in ("params", "local_heads", "opt_state"):
        assert got[part].keys() == want[part].keys(), part
        assert got[part], part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype, (part, k)
            np.testing.assert_allclose(got[part][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{part} {k}")
