"""Cross-tier TPGF in the port: ``fuse_tiers`` and the ``tier_sum``
kernel's plain version against the JAX package, the exact in-port
invariants of ``tests/test_tpgf_cross_tier.py``, and the width slice as a
whole against a live JAX ``Engine``.

The engine setting is ``tests/test_torch_engine.py``'s (reduced ViT, 6
clients, seed 0, availability 0.8, 2 local steps, batch 8) with the
ladder (0.25, 0.5, 0.75, 1.0): Eq. 1 depths [3, 2, 2, 1, 3, 3] and widths
[0.75, 0.5, 0.25, 0.25, 1.0, 1.0], so the d = 3 and d = 2 cohorts are
mixed. Three cases (fused/sgd, chained/sgd, fused/adamw), each with
``use_pallas`` off and on in the port (on the CPU the kernels' plain
versions); the reference runs its plain path.

Held: round losses within 1e-5 absolute and every other record field
exactly; final params within 1e-4; fleet widths and depths, availability
draws and batch indices exactly. ``fuse_tiers`` and ``tier_sum`` within
1e-5 of the reference; the invariants bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402
from repro.kernels.tpgf_fusion import ops as JFO  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.kernels.tpgf_fusion import ops as TFO  # noqa: E402
from repro_torch.kernels.tpgf_fusion import ref as TFR  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
LADDER = (0.25, 0.5, 0.75, 1.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs():
    return (JB.get_reduced("vit16_cifar").replace(**SMALL),
            TB.get_reduced("vit16_cifar").replace(**SMALL))


def _flat_j(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {p: x.detach().numpy() for p, x in tree_flatten_with_path(tree)}


def _tree_equal(a, b, msg=""):
    fa, fb = _flat_t(a), _flat_t(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{msg} {k}")


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray,
                        JM.init_params(jcfg, jax.random.PRNGKey(0)))


def _client_view_np(params, d):
    jcfg, _ = _cfgs()
    return JSN.split_params(jcfg, params, d)[0]


def _tiers_np(params, d, specs, seed):
    """[(width, mass, numpy tree on the width slice)]: each tier's update
    is the mean of ``n`` random client gradients on its slice."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    full = _client_view_np(params, d)
    out = []
    for w, mass, n in specs:
        view = JSN.slice_width(jcfg, full, w)
        grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), view) for _ in range(n)]
        out.append((w, np.float32(mass),
                    jax.tree.map(lambda *xs: sum(xs) / len(xs), *grads)))
    return out


def _t_tiers(tiers):
    return [TT.TierUpdate(w, torch.tensor(m), bridge.to_torch(t, device="cpu"))
            for w, m, t in tiers]


def _j_tiers(tiers):
    return [JT.TierUpdate(w, m, jax.tree.map(jnp.asarray, t))
            for w, m, t in tiers]


# ------------------------------------------------ fuse_tiers vs the JAX

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("specs", [
    [(0.25, 1.5, 2), (0.75, 0.7, 1)],
    [(0.25, 2.0, 1), (0.5, 0.0, 2), (0.75, 0.4, 3), (1.0, 1.1, 1)],
    [(1.0, 0.3, 2), (1.0, 0.0, 1)],
    [(0.5, 0.0, 1), (1.0, 0.0, 2)],
], ids=["two-narrow", "ladder-zero-tier", "full-width", "all-zero"])
def test_fuse_tiers_matches(params, specs, delta, use_pallas):
    """Gradient mode and delta mode (a base tree), with zero-weight tiers
    and widths below 1; the reference runs its plain path."""
    jcfg, tcfg = _cfgs()
    d = 2
    tiers = _tiers_np(params, d, specs, seed=len(specs))
    base = None
    if delta:
        rng = np.random.default_rng(9)
        base = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), _client_view_np(params, d))
    want = JT.fuse_tiers(jcfg, _j_tiers(tiers), base=None if base is None
                         else jax.tree.map(jnp.asarray, base))
    got = TT.fuse_tiers(tcfg, _t_tiers(tiers), use_pallas=use_pallas,
                        base=None if base is None
                        else bridge.to_torch(base, device="cpu"))
    fw, fg = _flat_j(want), _flat_t(got)
    assert fg.keys() == fw.keys()
    for k, w in fw.items():
        np.testing.assert_allclose(fg[k], w, err_msg=str(k), **TOL)


@pytest.mark.parametrize("T,shape", [(2, (1000,)), (3, (33, 65)),
                                     (4, (256, 128))])
def test_tier_sum_plain_version_matches_pallas_kernel(T, shape):
    rng = np.random.default_rng(42)
    leaves = [rng.normal(size=shape).astype(np.float32) for _ in range(T)]
    w = rng.uniform(0.0, 2.0, T).astype(np.float32)
    w[-1] = 0.0
    want = np.asarray(JFO.tier_sum_leaf([jnp.asarray(x) for x in leaves],
                                        [jnp.float32(x) for x in w]))
    tl = [torch.tensor(x) for x in leaves]
    before = TFO.tier_sum_leaf.launches
    got = TFO.tier_sum_leaf(tl, [torch.tensor(x) for x in w])
    assert TFO.tier_sum_leaf.launches == before   # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # one [T] weight tensor is the same call
    np.testing.assert_array_equal(
        TFO.tier_sum_leaf(tl, torch.tensor(w)).numpy(), got.numpy())
    np.testing.assert_array_equal(
        got.numpy(), TFR.tier_sum(tl, [torch.tensor(x) for x in w]).numpy())


# ------------------------------------------------ exact in-port invariants

CASES = [(2, [(0.25, 3.0, 2), (0.75, 0.6, 1)], 0),
         (3, [(0.5, 1.7, 1), (0.75, 20.0, 3), (1.0, 0.05, 2)], 1),
         (1, [(0.25, 0.3, 4), (0.5, 9.0, 1), (0.75, 1.0, 2),
              (1.0, 4.0, 1)], 2)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("d", [1, 3])
def test_single_full_width_tier_is_identity(params, d, use_pallas):
    """One width-1.0 tier fuses to its own tree bit for bit: the
    full-width Eq. 4 output survives the cross-tier stage."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(d)
    view = bridge.to_torch(_client_view_np(params, d), device="cpu")
    g = TT.fuse_gradients(_rand_like(view, rng), _rand_like(view, rng),
                          torch.tensor(0.3))
    fused = TT.fuse_tiers(tcfg, [TT.TierUpdate(1.0, torch.tensor(2.5), g)],
                          use_pallas=use_pallas)
    _tree_equal(fused, g, "single-tier identity")


def _rand_like(tree, rng):
    if isinstance(tree, dict):
        return {k: _rand_like(v, rng) for k, v in tree.items()}
    return torch.tensor(rng.normal(size=tuple(tree.shape))
                        .astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_single_holder_coordinate_is_undiluted(params, case):
    """The channels beyond the second-widest tier's keep are held by the
    widest tier alone: the fused value there is that tier's, exactly
    (``w/w == 1.0``)."""
    _, tcfg = _cfgs()
    d, specs, seed = case
    tiers = _t_tiers(_tiers_np(params, d, specs, seed))
    fused = TT.fuse_tiers(tcfg, tiers)
    top, runner_up = tiers[-1], tiers[-2]
    plan = TSN.width_plan(tcfg, 1.0)
    keep_lo = TSN.width_keep_sizes(tcfg, runner_up.width)
    keep_hi = TSN.width_keep_sizes(tcfg, top.width)
    lifted = _flat_t(TSN.widen_width(tcfg, top.tree, top.width))
    checked = 0
    for path, x in _flat_t(fused).items():
        name = path[-1]
        if name not in plan or keep_lo[name] >= keep_hi[name]:
            continue
        axis = x.ndim + plan[name][0]
        sl = tuple(slice(keep_lo[name], keep_hi[name]) if i == axis
                   else slice(None) for i in range(x.ndim))
        np.testing.assert_array_equal(x[sl], lifted[path][sl],
                                      err_msg=str(path))
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_order_invariance(params, case, use_pallas):
    _, tcfg = _cfgs()
    d, specs, seed = case
    tiers = _t_tiers(_tiers_np(params, d, specs, seed))
    base = _rand_like(bridge.to_torch(_client_view_np(params, d),
                                      device="cpu"),
                      np.random.default_rng(seed))
    for b in (None, base):
        a = TT.fuse_tiers(tcfg, tiers, base=b, use_pallas=use_pallas)
        for perm in np.random.default_rng(seed).permutation(
                [list(range(len(tiers)))] * 3):
            _tree_equal(a, TT.fuse_tiers(tcfg, [tiers[i] for i in perm],
                                         base=b, use_pallas=use_pallas),
                        f"perm={perm}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("zw", LADDER)
@pytest.mark.parametrize("case", CASES[:2])
def test_zero_weight_tier_is_noop(params, case, zw, delta, use_pallas):
    """A weight-0 tier changes nothing, bit for bit, in gradient and in
    delta mode; an all-zero-weight fusion in delta mode returns ``base``
    exactly (the frozen-server invariant)."""
    _, tcfg = _cfgs()
    d, specs, seed = case
    tiers = _t_tiers(_tiers_np(params, d, specs, seed))
    rng = np.random.default_rng(seed + 1)
    view = bridge.to_torch(_client_view_np(params, d), device="cpu")
    dead = TT.TierUpdate(zw, torch.tensor(0.0),
                         _rand_like(TSN.slice_width(tcfg, view, zw), rng))
    base = _rand_like(view, rng) if delta else None
    a = TT.fuse_tiers(tcfg, tiers, base=base, use_pallas=use_pallas)
    b = TT.fuse_tiers(tcfg, tiers + [dead], base=base,
                      use_pallas=use_pallas)
    _tree_equal(a, b, "zero-weight tier")
    if delta:
        allz = [t._replace(weight=torch.tensor(0.0)) for t in tiers]
        _tree_equal(TT.fuse_tiers(tcfg, allz, base=base,
                                  use_pallas=use_pallas), base,
                    "all-frozen delta == base")


# ----------------------------------------------- the slice as a whole

ENGINE = dict(seed=0, local_steps=2, batch_size=8, availability=0.8,
              width_tiers=LADDER)
N_CLIENTS = 6
ROUNDS = 2
RUNS = {"fused-sgd": dict(cross_tier="fused", optimizer="sgd", lr=0.3),
        "chained-sgd": dict(cross_tier="chained", optimizer="sgd", lr=0.3),
        "fused-adamw": dict(cross_tier="fused", optimizer="adamw",
                            lr=0.01)}


def _record_streams(engine):
    log = {"avail": [], "idx": []}
    draw, sample = engine.avail_model.draw, engine._sample_indices

    def logged_draw(n):
        out = draw(n)
        log["avail"].append(out.copy())
        return out

    def logged_sample(*a, **k):
        out = sample(*a, **k)
        log["idx"].append(out.copy())
        return out

    engine.avail_model.draw = logged_draw
    engine._sample_indices = logged_sample
    return log


@pytest.fixture(scope="module", params=sorted(RUNS))
def reference(request):
    jcfg, _ = _cfgs()
    kw = {**ENGINE, **RUNS[request.param]}
    eng = JEngine(jcfg, N_CLIENTS, "ssfl", **kw)
    weights = (jax.tree.map(np.asarray, eng.state.params),
               jax.tree.map(np.asarray, eng.state.local_heads))
    log = _record_streams(eng)
    recs = [eng.run_round() for _ in range(ROUNDS)]
    return {"kw": kw, "weights": weights, "recs": recs, "log": log,
            "params": _flat_j(eng.state.params),
            "depths": eng.state.fleet.depths.copy(),
            "widths": eng.state.fleet.widths.copy()}


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_pallas=False", "use_pallas=True"])
def port(request, reference):
    _, tcfg = _cfgs()
    eng = TEngine(tcfg.replace(use_pallas=request.param), N_CLIENTS,
                  "ssfl", device="cpu", **reference["kw"])
    bridge.install_weights(eng, *reference["weights"])
    log = _record_streams(eng)
    recs = [eng.run_round() for _ in range(ROUNDS)]
    return {"engine": eng, "recs": recs, "log": log,
            "params": _flat_t(eng.state.params)}


def test_width_rounds_match(reference, port):
    for want, rec in zip(reference["recs"], port["recs"]):
        assert rec.keys() == want.keys()
        assert rec["loss"] == pytest.approx(want["loss"], abs=1e-5)
        for k in want:
            if k != "loss":
                assert rec[k] == want[k], k


def test_width_final_params_match(reference, port):
    got = port["params"]
    assert got.keys() == reference["params"].keys()
    for k, want in reference["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-4,
                                   err_msg=str(k))


def test_width_fleet_and_streams_match(reference, port):
    fleet = port["engine"].state.fleet
    np.testing.assert_array_equal(fleet.depths, reference["depths"])
    np.testing.assert_array_equal(fleet.widths, reference["widths"])
    # two mixed cohorts, every tier trains
    for d in (2, 3):
        assert len(set(fleet.widths[fleet.depths == d])) > 1
    assert set(fleet.widths) == set(LADDER)
    for key in ("avail", "idx"):
        assert len(port["log"][key]) == len(reference["log"][key])
        for a, b in zip(port["log"][key], reference["log"][key]):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------- engine-level, in port

def _port_engine(**kw):
    _, tcfg = _cfgs()
    kw = {"seed": 0, "lr": 0.3, "local_steps": 1, "batch_size": 4, **kw}
    return TEngine(tcfg, 5, "ssfl", device="cpu", **kw)


def test_full_width_ladder_is_bit_exact_noop():
    """``width_tiers=(1.0,)`` runs the width grouping and lands bit for
    bit where the engine without a ladder lands."""
    a, b = _port_engine(), _port_engine(width_tiers=(1.0,))
    for _ in range(2):
        assert a.run_round() == b.run_round()
    _tree_equal(a.state.params, b.state.params, "ladder (1.0,)")


def test_all_frozen_mixed_cohorts_leave_the_server_bit_exact():
    """Availability 0: every tier of every mixed cohort is frozen, so
    the fused server update is a bit-exact no-op on the server branch
    and its AdamW moments (and ``t`` stays 0)."""
    eng = _port_engine(width_tiers=LADDER, availability=0.0,
                       optimizer="adamw", lr=0.05)
    head = eng.state.params["head"].clone()
    eng.run_round()
    assert torch.equal(eng.state.params["head"], head)
    srv = eng.state.opt_state["server"]
    assert int(srv["t"]) == 0
    assert all(not x.any() for _, x in tree_flatten_with_path(srv["m"]))


@pytest.mark.parametrize("cross_tier", ["fused", "chained"])
def test_builder_runs_a_width_fleet(cross_tier):
    _, tcfg = _cfgs()
    eng = (TEngine.builder(tcfg).clients(6, availability=0.8)
           .optimizer("sgd", lr=0.3).rounds(local_steps=1, batch_size=4)
           .execution(device="cpu", width_tiers=(0.5, 1.0),
                      cross_tier=cross_tier).build())
    assert eng.cross_tier == cross_tier
    assert set(eng.state.fleet.widths) == {0.5, 1.0}
    rec = eng.train(1, eval_every=1)
    assert np.isfinite(rec["loss"]) and 0.0 <= rec["accuracy"] <= 1.0


def test_cross_tier_is_validated():
    with pytest.raises(ValueError, match="cross_tier"):
        _port_engine(cross_tier="nope")
