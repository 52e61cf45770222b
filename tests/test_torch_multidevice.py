"""Fleet sharding in the port: ``Engine(mesh=make_fleet_mesh(R))`` over R
gloo ranks on the CPU, after the JAX package's ``tests/test_multidevice.py``
and at its setting (``_multidevice_child.py``: reduced ViT, 3 layers,
d_model 24; seed 0, lr 0.3, local_steps 2, batch 4; 13 clients at
``availability=0.7, sample_frac=0.8``).

The child ``tests/_torch_multidevice_child.py`` (torch, numpy and the
port only) spawns the ranks and writes their results; this module builds
the live reference's REPLICATED engine and the port's meshless engine, from
the same weights, once in a module fixture while the children run, and
holds the sharded runs to both: round loss within 1e-4, ``comm_mb``
exactly, params and the local heads within atol 1e-5 / rtol 1e-5 (the
reference's own sharded bounds), for every registered strategy on 2 ranks,
``ssfl`` on 3 ranks (ownership blocks 5/4/4) and the width ladder
(0.5, 1.0) fused. After every round the replicated state (params,
``opt_state``: the server moments and the FedBuff buffer) is bit for bit
the same on every rank.

Bit for bit under the mesh: a mesh of extent 1 against the meshless
engine; the frozen server (a round at availability 0 leaves the global
head and every server moment and AdamW ``t``), full width and on the
ladder; resume (two rounds against one + save + restore into a fresh
mesh engine + one), full width and on the ladder. ``evaluate`` gives
the meshless engine's accuracies with either head. The sharded checkpoint
restores into a meshless port engine and loads in the reference's
``Engine.restore``. Each rank's workspace and heads hold its own rows.
The sanitizer on the mesh: healthy rounds within 1e-5 of the meshless
engine; NaN in client 3's data raises ``SlotSanitizerError`` on every
rank with the client's global cohort position (the meshless engine's
slots), each within a third of the process group's timeout of the
round's start.

No counterpart: ``TestShardedCompileCount``,
``test_non_dividing_bucket_falls_back`` and
``test_bucket_rounds_to_whole_slots_per_shard``. Eager PyTorch compiles
nothing per cohort and has no padded slots (departure (b)); a fleet that
does not divide the ranks splits into unequal contiguous blocks
(departure (h)), held by the 13-client cases.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import base as JB  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_multidevice_child.py")
SMALL = dict(n_layers=3, d_model=24, n_heads=2, n_kv_heads=2, head_dim=12,
             d_ff=48, image_size=16, n_classes=6)
ARGS = dict(seed=0, lr=0.3, local_steps=2, batch_size=4)
PARITY = dict(availability=0.7, sample_frac=0.8)
LADDER = (0.5, 1.0)
STRATEGIES = ("ssfl", "hasfl", "sfl", "dfl", "fedavg", "fedavgm", "fedadam",
              "fedyogi", "unstable", "async_buffered")
CHILD_TIMEOUT = 300
GROUP_TIMEOUT = 120   # the child's process groups' timeout, in seconds
# the child's cases, by the number of ranks they run on
CASES = {1: ["extent1"],
         2: [f"parity_{s}" for s in STRATEGIES]
         + ["width", "frozen", "frozen_width", "resume", "resume_width",
            "storage", "sanitize"],
         3: ["parity_ssfl"]}


def _jcfg():
    return JB.get_reduced("vit16_cifar").replace(**SMALL)


def _tcfg():
    return TB.get_reduced("vit16_cifar").replace(**SMALL)


def _jax_arrays(eng):
    out = {}
    for prefix, tree in (("params", eng.state.params),
                         ("heads", eng.state.local_heads)):
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join([prefix, *(str(k.key) for k in p)])] = np.asarray(x)
    return out


def _torch_arrays(eng):
    out = {}
    for prefix, tree in (("params", eng.state.params),
                         ("heads", eng.state.local_heads),
                         ("opt", eng.state.opt_state)):
        for p, x in tree_flatten_with_path(tree):
            out["/".join([prefix, *map(str, p)])] = x.detach().numpy()
    return out


def _two_rounds(eng):
    recs = [eng.run_round() for _ in range(2)]
    return {"loss": [r["loss"] for r in recs],
            "comm_mb": [r["comm_mb"] for r in recs]}


def _accuracy(eng):
    return [eng.evaluate(head=h) for h in ("global", "local")]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The child's results (by ranks, then case) and the reference's and
    the meshless port's runs (by case)."""
    root = tmp_path_factory.mktemp("fleet")
    jweights = {}
    for n in (13, 8):
        eng = JEngine(_jcfg(), n, "ssfl", **ARGS)
        jweights[n] = (jax.tree.map(np.asarray, eng.state.params),
                       jax.tree.map(np.asarray, eng.state.local_heads))
        params, heads = jweights[n]
        np.savez(root / f"weights_{n}.npz",
                 **{f"params/{'/'.join(p)}": x for p, x in
                    tree_flatten_with_path(params)},
                 **{f"heads/{'/'.join(p)}": x for p, x in
                    tree_flatten_with_path(heads)})
    # one child runs the meshes one after the other, beside this process;
    # its output goes to files: a full pipe would stall it while this
    # process runs the reference
    groups = [f"{world}:{','.join(cases)}" for world, cases in CASES.items()]
    with open(root / "out.txt", "w") as out, \
            open(root / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, CHILD, str(root), *groups], cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=out,
            stderr=err)

    # meanwhile: the reference's replicated runs and the meshless port's
    ref, port = {}, {}
    runs = {s: (s, {}) for s in STRATEGIES}
    runs["width"] = ("ssfl", dict(width_tiers=LADDER))
    for case, (strategy, kw) in runs.items():
        jeng = JEngine(_jcfg(), 13, strategy, **ARGS, **PARITY, **kw)
        for got, want in zip(jax.tree.leaves(jeng.state.params),
                             jax.tree.leaves(jweights[13][0])):
            np.testing.assert_array_equal(np.asarray(got), want)
        ref[case] = _two_rounds(jeng)
        ref[case].update(_jax_arrays(jeng))
        teng = TEngine(_tcfg(), 13, strategy, device="cpu", **ARGS, **PARITY,
                       **kw)
        bridge.install_weights(teng, *jweights[13])
        port[case] = _two_rounds(teng)
        port[case].update(_torch_arrays(teng), accuracy=_accuracy(teng))

    try:
        proc.wait(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out = (root / "out.txt").read_text()
    err = (root / "err.txt").read_text()
    assert proc.returncode == 0, (out[-1500:], err[-3000:])
    dirs, results = {}, {}
    for world in CASES:
        assert f"CHILD_OK {world} " in out, out
        dirs[world] = root / f"ranks{world}"
        results[world] = {f.stem: dict(np.load(f)) for f in
                          dirs[world].glob("*.npz")}
    return {"shd": results, "ref": ref, "port": port, "dirs": dirs,
            "jweights": jweights}


def _assert_parity(shd, want, what):
    """Losses within 1e-4, ``comm_mb`` exactly, params and heads within
    atol 1e-5 / rtol 1e-5."""
    for a, b in zip(want["loss"], shd["loss"]):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) < 1e-4, \
            (what, want["loss"], shd["loss"])
    np.testing.assert_array_equal(shd["comm_mb"], want["comm_mb"])
    keys = [k for k in want if k.startswith(("params/", "heads/"))]
    assert keys and set(keys) <= set(shd), what
    for k in keys:
        np.testing.assert_allclose(shd[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=f"{what} {k}")


def _assert_replicated(shd):
    assert list(shd["drift"]) == [0.0, 0.0], shd["drift"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_every_strategy_sharded_matches_replicated(fleet, strategy):
    shd = fleet["shd"][2][f"parity_{strategy}"]
    assert int(shd["fleet_shards"]) == 2
    _assert_parity(shd, fleet["ref"][strategy], f"{strategy} vs reference")
    _assert_parity(shd, fleet["port"][strategy], f"{strategy} vs meshless")
    _assert_replicated(shd)


@pytest.mark.parametrize("case", ["ssfl", "sfl", "fedavg", "width"])
def test_evaluate_on_the_mesh(fleet, case):
    """The global head, and the local ensemble whose logits each rank
    sums over the heads it owns: the meshless engine's accuracies."""
    shd = fleet["shd"][2][case if case == "width" else f"parity_{case}"]
    np.testing.assert_array_equal(shd["accuracy"],
                                  fleet["port"][case]["accuracy"])


def test_three_ranks_thirteen_clients(fleet):
    shd = fleet["shd"][3]["parity_ssfl"]
    assert int(shd["fleet_shards"]) == 3
    _assert_parity(shd, fleet["ref"]["ssfl"], "3 ranks vs reference")
    _assert_parity(shd, fleet["port"]["ssfl"], "3 ranks vs meshless")
    _assert_replicated(shd)


def test_width_ladder_fused_parity(fleet):
    shd = fleet["shd"][2]["width"]
    _assert_parity(shd, fleet["ref"]["width"], "ladder vs reference")
    _assert_parity(shd, fleet["port"]["width"], "ladder vs meshless")
    _assert_replicated(shd)


@pytest.mark.parametrize("case", ["frozen", "frozen_width"])
def test_frozen_server_is_bit_exact(fleet, case):
    """A round with nobody reachable leaves the global head, every server
    moment and AdamW's ``t`` bit for bit."""
    got = fleet["shd"][2][case]
    keys = [k[len("before/"):] for k in got if k.startswith("before/")]
    held = [k for k in keys if k.startswith(("params/head", "opt/"))]
    assert "opt/server/t" in held and "params/head" in held, keys
    assert any(k.startswith("opt/server/m/") for k in held), held
    for k in held:
        np.testing.assert_array_equal(got[f"after/{k}"], got[f"before/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("case", ["resume", "resume_width"])
def test_resume_is_bit_exact(fleet, case):
    got = fleet["shd"][2][case]
    assert int(got["round_idx"]) == 1
    keys = [k[len("straight/"):] for k in got if k.startswith("straight/")]
    assert any(k.startswith("heads/") for k in keys)
    assert any(k.startswith("opt/server/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[f"resumed/{k}"],
                                      got[f"straight/{k}"], err_msg=k)


def test_sharded_checkpoint_restores_meshless(fleet):
    """Every rank's heads are in the one file: a meshless port engine
    restores it to the sharded state of that moment, bit for bit."""
    saved = {k[len("saved/"):]: v for k, v in
             fleet["shd"][2]["resume"].items() if k.startswith("saved/")}
    eng = TEngine(_tcfg(), 8, "ssfl", device="cpu", optimizer="adamw",
                  **dict(ARGS, lr=0.01), **PARITY)
    eng.restore(str(fleet["dirs"][2] / "ck_resume"))
    got = _torch_arrays(eng)
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert eng.state.round_idx == 1


def test_sharded_checkpoint_loads_in_reference(fleet):
    saved = {k[len("saved/"):]: v for k, v in
             fleet["shd"][2]["resume"].items() if k.startswith("saved/")}
    eng = JEngine(_jcfg(), 8, "ssfl", optimizer="adamw",
                  **dict(ARGS, lr=0.01), **PARITY)
    eng.restore(str(fleet["dirs"][2] / "ck_resume"))
    got = _jax_arrays(eng)
    assert got.keys() == {k for k in saved if not k.startswith("opt/")}
    for k, v in got.items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert int(np.asarray(eng.state.opt_state["server"]["t"])) == \
        int(saved["opt/server/t"])


@pytest.mark.parametrize("strategy", ["ssfl", "sfl"])
def test_extent_one_is_the_meshless_path(fleet, strategy):
    got = fleet["shd"][1]["extent1"]
    assert int(got[f"{strategy}/mesh/fleet_shards"]) == 1
    keys = [k[len(f"{strategy}/mesh/"):] for k in got
            if k.startswith(f"{strategy}/mesh/")]
    assert "loss" in keys and any(k.startswith("heads/") for k in keys)
    for k in keys:
        if k != "fleet_shards":
            np.testing.assert_array_equal(got[f"{strategy}/mesh/{k}"],
                                          got[f"{strategy}/meshless/{k}"],
                                          err_msg=k)


def test_each_rank_holds_its_own_rows(fleet):
    """13 clients over 2 ranks: 7 and 6, for the workspace's every leaf and
    for the heads; the owners are contiguous blocks."""
    got = fleet["shd"][2]["storage"]
    np.testing.assert_array_equal(got["rows"], [[7, 6], [7, 6], [7, 6]])
    np.testing.assert_array_equal(got["owner"], [0] * 7 + [1] * 6)


def test_sanitizer_healthy_rounds_match_meshless(fleet):
    loss = fleet["shd"][2]["sanitize"]["loss"]
    assert loss.shape == (2, 2) and np.isfinite(loss).all()
    np.testing.assert_allclose(loss[:, 0], loss[:, 1], rtol=0, atol=1e-5)


def test_sanitizer_trip_raises_on_every_rank(fleet):
    shd = fleet["shd"][2]
    want = shd["trip_meshless"]
    assert int(want["raised"]) == 1 and int(want["position"]) in \
        list(want["slots"])
    for rank in (0, 1):
        got = shd[f"trip_rank{rank}"]
        assert int(got["raised"]) == 1, rank
        assert "cohort_kernel" in str(got["message"])
        np.testing.assert_array_equal(got["slots"], want["slots"])
        # the raise came well before a collective's 120 s timeout: no
        # rank waited for another that had already raised
        assert float(got["seconds"]) < GROUP_TIMEOUT / 3, (rank,
                                                           got["seconds"])


class _Mesh:
    """A stand-in for a DeviceMesh: its size and this rank's position."""

    def __init__(self, size, rank=0):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self, name):
        assert name == "data"
        return self._rank


@pytest.mark.parametrize("n,world,blocks", [
    (13, 3, [5, 4, 4]), (13, 2, [7, 6]), (8, 2, [4, 4]), (2, 3, [1, 1, 0])])
def test_fleet_owner_is_contiguous_blocks(n, world, blocks):
    owner = SH.fleet_owner(n, _Mesh(world))
    np.testing.assert_array_equal(np.bincount(owner, minlength=world), blocks)
    assert (np.diff(owner) >= 0).all()
    for r in range(world):
        lo, hi = SH.owned_range(n, _Mesh(world, r))
        np.testing.assert_array_equal(np.where(owner == r)[0],
                                      np.arange(lo, hi))


def test_helpers_are_the_identity_without_a_mesh():
    x = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.ones(3)}
    assert SH.fleet_extent(None) == 1 and SH.fleet_rank(None) == 0
    assert SH.owned_range(3, None) == (0, 3)
    assert SH.shard_fleet(x, 3, None) is x
    assert SH.fleet_gather(x, 3, None) is x
    assert SH.fleet_sum_tree(x, None) is x
    assert SH.fleet_sum([x["a"]], None)[0] is x["a"]
    assert SH.fleet_broadcast(x, 0, None) is x
    assert SH.replicated_drift(x, None) == 0.0


def test_make_fleet_mesh_refusals():
    """Checked before any process group is made."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="wants 2 ranks"):
        make_fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_fleet_mesh(1, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nccl"):
        make_fleet_mesh(1, device="cpu", backend="nccl")
    assert not dist.is_initialized()
