"""The port's FedBuff update buffer and ``async_buffered`` strategy against
the live JAX package, and the strategy's invariants within the port.

Exact against the reference, on the same pushes: the buffer's ``weight``,
``staleness``, ``round`` and ``count`` (their dtypes too), the ring drop,
``ready`` under every policy; ``flush`` within 1e-6 relative of the
reference's einsum on the same numpy deltas. Two rounds at the
``tests/_torch_parity.py`` setting (reduced ViT, 6 clients, seed 0, SGD
lr 0.3, the reference's weights) for ``sgd``, ``fedadam`` and ``fedyogi``
servers and
the ``round`` and ``age`` policies, with ``use_pallas`` off and on: round
losses 1e-5, cost-model records exactly, final params and the whole
``opt_state`` (server moments, FedOpt moments, the buffer) 1e-4, the
flush count and buffer tags exactly. Within the port: the frozen server
bit for bit under every server optimizer, ``capacity=1``/``"round"``/SGD
at lr 1.0 recovering ``unstable``, entries carrying their own server
view, a capacity change re-initialising the buffer, bit-identical resume,
an adopted buffer never writing through into its source arrays, and a
checkpoint written by either package restoring in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import _torch_parity as P  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402
from repro.federated import buffer as JBUF  # noqa: E402
from repro.federated.strategies.async_buffered import \
    BufferedAsync as JBufferedAsync  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core.fault import AvailabilityModel  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated import buffer as BUF  # noqa: E402
from repro_torch.federated.strategies import BufferedAsync  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402


def _cfg():
    return TB.get_reduced("vit16_cifar").replace(**P.SMALL)


def _engine(strategy, n_clients=6, **kw):
    return TEngine(_cfg(), n_clients, strategy, device="cpu",
                   **dict(P.ARGS, **kw))


def _flat(tree):
    return dict(tree_flatten_with_path(tree))


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# ------------------------------------------------------------- the buffer

TEMPLATE = {"w": np.zeros((2, 3), np.float32), "b": {"c": np.zeros(4,
                                                                   np.float32)}}


def _deltas(n, seed=0):
    rng = np.random.default_rng(seed)
    return [tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                     TEMPLATE) for _ in range(n)]


def _pushes(seed=0):
    """(delta, weight, staleness, round) entries, some tags fractional."""
    rng = np.random.default_rng(seed + 1)
    return [(d, float(rng.integers(1, 5)), float(rng.uniform(0, 3)),
             int(r)) for d, r in zip(_deltas(5, seed), [0, 0, 1, 2, 2])]


def _both(capacity):
    t = BUF.init_buffer(tree_map(torch.as_tensor, TEMPLATE), capacity)
    j = JBUF.init_buffer(TEMPLATE, capacity)
    return t, j


def _assert_tags_equal(t, j):
    for k in ("weight", "staleness", "round", "count"):
        want = np.asarray(j[k])
        got = t[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for p, x in tree_flatten_with_path(t["deltas"]):
        want = np.asarray(j["deltas"][p[0]] if len(p) == 1
                          else j["deltas"][p[0]][p[1]])
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("capacity", [1, 3, 5, 8])
def test_push_tags_and_ring_drop_match_reference(capacity):
    t, j = _both(capacity)
    assert BUF.capacity_of(t) == capacity and BUF.fill_count(t) == 0
    for delta, w, s, r in _pushes():
        same = BUF.push(t, tree_map(torch.as_tensor, delta), w, s, r)
        assert same is t                                # in place
        j = JBUF.push(j, tree_map(jnp.asarray, delta), w, s, r)
        assert BUF.fill_count(t) == JBUF.fill_count(j)
        _assert_tags_equal(t, j)


@pytest.mark.parametrize("policy,max_age", [("count", None), ("round", None),
                                            ("age", 1), ("age", 2)])
def test_ready_matches_reference_under_every_policy(policy, max_age):
    t, j = _both(4)
    for delta, w, s, r in [(None, 0, 0, 0)] + _pushes()[:4]:
        if delta is not None:
            BUF.push(t, tree_map(torch.as_tensor, delta), w, s, r)
            j = JBUF.push(j, tree_map(jnp.asarray, delta), w, s, r)
        for now in range(5):
            assert BUF.ready(t, policy=policy, max_age=max_age,
                             round_idx=now) == JBUF.ready(
                j, policy=policy, max_age=max_age, round_idx=now)


@pytest.mark.parametrize("gamma", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("n_push", [1, 3, 5])
def test_flush_matches_reference_einsum(gamma, n_push):
    t, j = _both(6)
    for delta, w, s, r in _pushes(seed=n_push)[:n_push]:
        BUF.push(t, tree_map(torch.as_tensor, delta), w, s, r)
        j = JBUF.push(j, tree_map(jnp.asarray, delta), w, s, r)
    got, fresh = BUF.flush(t, gamma=gamma, round_idx=4)
    want, jfresh = JBUF.flush(j, gamma=gamma, round_idx=4)
    for p, x in tree_flatten_with_path(got):
        ref = np.asarray(want[p[0]] if len(p) == 1 else want[p[0]][p[1]])
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert fresh is t and BUF.fill_count(fresh) == 0
    _assert_tags_equal(fresh, jfresh)


def test_flush_hand_computed_discount():
    """gamma 1, flushed at round 2: A (weight 2, staleness 1, pushed at
    round 0: effective 3) weighs 2/4, B (weight 1, staleness 0, round 1:
    effective 1) weighs 1/2 — equal after normalization."""
    buf = BUF.init_buffer({"w": torch.zeros(2)}, 3)
    BUF.push(buf, {"w": torch.tensor([1.0, 0.0])}, 2.0, 1.0, 0)
    BUF.push(buf, {"w": torch.tensor([0.0, 1.0])}, 1.0, 0.0, 1)
    delta, _ = BUF.flush(buf, gamma=1.0, round_idx=2)
    torch.testing.assert_close(delta["w"], torch.tensor([0.5, 0.5]))


def test_buffer_errors_and_meta_template():
    buf = BUF.init_buffer({"w": torch.zeros(2)}, 2)
    with pytest.raises(ValueError):
        BUF.ready(buf, policy="never")
    with pytest.raises(ValueError):
        BUF.flush(buf)
    with pytest.raises(ValueError):
        BUF.init_buffer({"w": torch.zeros(2)}, 0)
    BUF.push(buf, {"w": torch.ones(2)}, 1.0, 0.0, 0)
    with pytest.raises(ValueError):
        BUF.ready(buf, policy="age", round_idx=1)   # max_age required
    meta = BUF.init_buffer({"w": torch.empty((3, 5), device="meta")}, 4)
    assert meta["deltas"]["w"].shape == (4, 3, 5)
    assert meta["deltas"]["w"].device.type == "meta"


def test_strategy_validates_its_settings():
    with pytest.raises(ValueError):
        BufferedAsync(policy="sometimes")
    with pytest.raises(ValueError):
        BufferedAsync(policy="age")
    with pytest.raises(ValueError):
        BufferedAsync(capacity=0)
    BufferedAsync(policy="age", max_age=3)


# ------------------------------------------- two rounds against the reference

CASES = {
    "sgd": dict(capacity=2),
    "fedadam": dict(capacity=3, server_opt="fedadam", server_lr=0.03),
    "fedyogi": dict(capacity=2, server_opt="fedyogi", server_lr=0.03),
    "round": dict(capacity=2, policy="round", server_opt="fedadam",
                  server_lr=0.03),
    "age": dict(capacity=5, policy="age", max_age=1),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def reference(case):
    strat = JBufferedAsync(**CASES[case])
    ref = P.run_reference(strat)
    ref["flushes"] = strat.flushes
    return ref


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, case, reference):
    strat = BufferedAsync(**CASES[case])
    return P.run_port(reference, request.param, strat)


def test_records_match(reference, port):
    P.assert_records_match(reference, port)


def test_params_and_whole_opt_state_match(reference, port):
    P.assert_close(port["params"], reference["params"], "params")
    P.assert_close(port["opt_state"], reference["opt_state"], "opt_state")
    assert BUF.SLOT in {p[0] for p in port["opt_state"]}


def test_flushes_tags_and_streams_match(reference, port):
    P.assert_streams_match(reference, port)
    eng = port["engine"]
    assert eng.strategy.flushes == reference["flushes"] > 0
    buf = eng.state.opt_state[BUF.SLOT]
    jbuf = reference["engine"].state.opt_state[JBUF.SLOT]
    for k in ("weight", "staleness", "round", "count"):
        want = np.asarray(jbuf[k])
        assert buf[k].numpy().dtype == want.dtype
        np.testing.assert_array_equal(buf[k].numpy(), want, err_msg=k)


# ------------------------------------------------ the invariants, in the port

@pytest.mark.parametrize("server_opt", ["sgd", "fedadam", "fedyogi"])
def test_frozen_server_is_bit_exact(server_opt):
    """Server unreachable from round 0: through pushes and flushes the
    server head and the kernel server moments stay bit for bit."""
    strat = BufferedAsync(capacity=2, server_opt=server_opt, server_lr=0.03)
    eng = _engine(strat, n_clients=5, optimizer="adamw", lr=0.05,
                  availability=0.0)
    head = eng.state.params["head"].clone()
    for _ in range(4):
        eng.run_round()
    assert strat.flushes >= 1
    assert torch.equal(head, eng.state.params["head"])
    assert int(eng.state.opt_state["server"]["t"]) == 0


def test_round_policy_with_one_cohort_recovers_unstable():
    mk = lambda s: _engine(s, local_steps=2)
    a = mk("unstable")
    b = mk(BufferedAsync(capacity=1, policy="round", server_opt="sgd",
                         server_lr=1.0))
    for eng in (a, b):   # ONE depth cohort, the same edit on both
        eng.state.fleet.depths[:] = 2
        eng.state.fleet.feasible[:] = True
    for _ in range(2):
        a.run_round(), b.run_round()
    for (p, x), (_, y) in zip(tree_flatten_with_path(a.state.params),
                              tree_flatten_with_path(b.state.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6, msg=str(p))


def test_params_do_not_move_between_flushes():
    strat = BufferedAsync(capacity=50)
    eng = _engine(strat)
    before = {p: x.clone() for p, x in tree_flatten_with_path(
        eng.state.params)}
    for _ in range(3):
        eng.run_round()
    assert strat.flushes == 0
    assert BUF.fill_count(eng.state.opt_state[BUF.SLOT]) > 0
    for p, x in tree_flatten_with_path(eng.state.params):
        assert torch.equal(x, before[p]), p


def test_entries_carry_their_own_server_view():
    eng = _engine(BufferedAsync(capacity=50),
                  participation=AvailabilityModel(1.0))
    eng.run_round()
    buf = eng.state.opt_state[BUF.SLOT]
    n = BUF.fill_count(buf)
    assert n >= 2                       # several depth cohorts
    heads = buf["deltas"]["head"][:n]
    assert (heads[0] - heads[1]).abs().max() > 0


def test_capacity_change_reinitializes_buffer():
    eng = _engine(BufferedAsync(capacity=4), n_clients=4)
    eng.run_round()
    assert BUF.capacity_of(eng.state.opt_state[BUF.SLOT]) == 4
    eng.strategy = BufferedAsync(capacity=2)
    eng.run_round()
    assert BUF.capacity_of(eng.state.opt_state[BUF.SLOT]) == 2


@pytest.mark.parametrize("server_opt", ["fedadam", "fedyogi"])
def test_resume_is_bit_identical(tmp_path, server_opt):
    """3 rounds == 1 round + save (mid-fill) + a fresh engine + restore +
    2 rounds, bit for bit: params, heads, the buffer, both server
    states."""
    mk = lambda: _engine(
        BufferedAsync(capacity=5, server_opt=server_opt, server_lr=0.03),
        optimizer="adamw", lr=0.01, availability=0.7, sample_frac=0.8)
    a = mk()
    for _ in range(3):
        a.run_round()
    b = mk()
    b.run_round()
    assert BUF.fill_count(b.state.opt_state[BUF.SLOT]) > 0
    b.save(str(tmp_path / "ck"))
    c = mk()
    c.restore(str(tmp_path / "ck"))
    assert c._buffer_ok is None and c._fedopt_ok is None
    assert c.state.round_idx == 1
    c.run_round()
    c.run_round()
    assert a.strategy.flushes == b.strategy.flushes + c.strategy.flushes
    for part in ("params", "local_heads", "opt_state"):
        _assert_trees_equal(getattr(a.state, part), getattr(c.state, part))
    assert sorted(a.state.opt_state) == ["server", "server_fedopt",
                                         BUF.SLOT]


def test_adopted_buffer_does_not_write_into_its_source(tmp_path):
    """A buffer handed over as numpy arrays (a checkpoint's, as loaded)
    gets tensors of its own: the next pushes leave the arrays alone."""
    eng = _engine(BufferedAsync(capacity=5))
    eng.run_round()
    eng.save(str(tmp_path / "ck"))
    tree, _ = load_checkpoint(str(tmp_path / "ck"))
    arrays = tree["opt_state"][BUF.SLOT]
    copies = tree_map(np.copy, arrays)
    eng.state.opt_state[BUF.SLOT] = arrays
    eng._buffer_ok = None
    eng.run_round()
    now = eng.state.opt_state[BUF.SLOT]
    assert isinstance(now["count"], torch.Tensor)
    assert not np.array_equal(now["round"].numpy(), copies["round"])
    for (p, x), (_, y) in zip(tree_flatten_with_path(arrays),
                              tree_flatten_with_path(copies)):
        np.testing.assert_array_equal(x, y, err_msg=str(p))


# ----------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Each package writes a checkpoint of ``async_buffered``/``fedadam``
    after round 1 (mid-fill), runs round 2; the other restores it and runs
    round 2."""
    tmp = tmp_path_factory.mktemp("cross")
    kw = dict(capacity=5, server_opt="fedadam", server_lr=0.03)
    args = dict(P.ARGS, optimizer="adamw", lr=0.01)
    jcfg = JB.get_reduced("vit16_cifar").replace(**P.SMALL)
    ref = JEngine(jcfg, 6, JBufferedAsync(**kw), **args)
    weights = (jax.tree.map(np.asarray, ref.state.params),
               jax.tree.map(np.asarray, ref.state.local_heads))
    port = TEngine(_cfg(), 6, BufferedAsync(**kw), device="cpu", **args)
    bridge.install_weights(port, *weights)
    out = {}
    for name, eng in (("reference", ref), ("port", port)):
        eng.run_round()
        eng.save(str(tmp / name))
        out[name] = {"round2": eng.run_round(), "engine": eng}
    j_reader = JEngine(jcfg, 6, JBufferedAsync(**kw), **args)
    j_reader.restore(str(tmp / "port"))
    t_reader = TEngine(_cfg(), 6, BufferedAsync(**kw), device="cpu", **args)
    t_reader.restore(str(tmp / "reference"))
    out["reference"]["reader"] = (t_reader, t_reader.run_round())
    out["port"]["reader"] = (j_reader, j_reader.run_round())
    return out


def _opt_np(eng):
    if isinstance(eng, TEngine):
        return {p: x.numpy() for p, x in
                tree_flatten_with_path(eng.state.opt_state)}
    return P.flat_jax(eng.state.opt_state)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_async_checkpoint_crosses_packages(crossed, writer):
    reader, rec = crossed[writer]["reader"]
    want, eng = crossed[writer]["round2"], crossed[writer]["engine"]
    assert rec["round"] == want["round"] == 2
    assert rec["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert reader.participation.get_state() == eng.participation.get_state()
    np.testing.assert_array_equal(reader._staleness, eng._staleness)
    got, ref = _opt_np(reader), _opt_np(eng)
    assert got.keys() == ref.keys()
    assert any(k[0] == "update_buffer" for k in got)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=str(k))
