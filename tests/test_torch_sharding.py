"""The port's LM sharding rules (``repro_torch.launch.sharding``) against
the reference's (``repro.launch.sharding``), leaf for leaf, on the
abstract production meshes (16, 16) and (2, 16, 16): ``param_pspecs``
for every architecture, ``batch_pspecs`` for every input shape and
``cache_pspecs`` for both decode shapes and both ``decode_cache_shard``
values, with the head and vocab fallbacks of ``tests/test_sharding.py``.

JAX prints a one-axis spec entry as ``'data'`` or ``('data',)`` by where
it came from; entries are compared as tuples of axis names.

``placements()`` runs on a ``"fake"`` process group of 256 and 512 ranks
in a subprocess: ``init_process_group`` changes the default group of its
process, which a pytest worker must keep.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import base as JB
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh

from repro_torch.configs import base as TB
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.tree import tree_flatten_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jflat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            tuple(_norm(e) for e in s) for p, s in flat}


def _tflat(specs):
    out = {}

    def walk(node, path):
        if isinstance(node, TSH.P):
            out[path] = tuple(_norm(e) for e in node)
        else:
            for k, v in node.items():
                walk(v, path + (k,))
    walk(specs, ())
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JST.params_specs(JB.get_config(arch))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return TST.params_specs(TB.get_config(arch))


def _meshes(name):
    shape, axes = MESHES[name]
    return j_abstract_mesh(shape, axes), make_abstract_mesh(shape, axes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_param_pspecs_match_the_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    want = _jflat(JSH.param_pspecs(JB.get_config(arch), _jparams(arch), jm))
    got = _tflat(TSH.param_pspecs(TB.get_config(arch), _tparams(arch), tm))
    assert got == want
    # every sharded dim divides its mesh extent
    shapes = dict(tree_flatten_with_path(_tparams(arch)))
    for path, spec in got.items():
        for dim, axes in enumerate(spec):
            if axes:
                assert shapes[path].shape[dim] % int(np.prod(
                    [tm.shape[a] for a in axes])) == 0, (path, spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_batch_pspecs_match_the_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    for name, shape in JB.INPUT_SHAPES.items():
        jcfg, tcfg = JB.get_config(arch), TB.get_config(arch)
        jb = JST.batch_specs(jcfg, shape)
        tb = TST.batch_specs(tcfg, TB.INPUT_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in tb.items()} == \
            {k: tuple(v.shape) for k, v in jb.items()}
        want = _jflat(JSH.batch_pspecs(jcfg, shape, jb, jm))
        got = _tflat(TSH.batch_pspecs(tcfg, shape, tb, tm))
        assert got == want, name
        tok = TST.token_specs(tcfg, TB.INPUT_SHAPES[name])
        assert _tflat(TSH.batch_pspecs(tcfg, shape, {"token": tok}, tm)) \
            == _jflat(JSH.batch_pspecs(jcfg, shape, {
                "token": JST.token_specs(jcfg, shape)}, jm))


@pytest.mark.parametrize("shard", ["heads", "seq"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_cache_pspecs_match_the_reference(arch, mesh, shard):
    jm, tm = _meshes(mesh)
    jcfg = JB.get_config(arch).replace(decode_cache_shard=shard)
    tcfg = TB.get_config(arch).replace(decode_cache_shard=shard)
    for name in ("decode_32k", "long_500k"):
        if JB.skip_reason(arch, name):
            continue
        shape = JB.INPUT_SHAPES[name]
        jc = JST.cache_specs(jcfg, shape)
        tc = TST.cache_specs(tcfg, TB.INPUT_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in tc.items() if k != "idx"} == \
            {k: tuple(v.shape) for k, v in jc.items() if k != "idx"}
        want = _jflat(JSH.cache_pspecs(jcfg, jc, jm))
        got = _tflat(TSH.cache_pspecs(tcfg, tc, tm))
        assert got == want, name


def test_tricky_head_fallbacks_and_vocab_padding():
    """Whisper's 12 heads and Hymba's 25 do not divide 16, but their
    flattened H·hd projections do: the spec shards the flat dim (half a
    head a rank for Llama-3.2-3B's ``wk``), as the reference's does; the
    seq cache variant shards the window over ``"model"``."""
    _, tm = _meshes("16x16")
    for arch in ("whisper_small", "hymba_1_5b", "gemma_2b", "llama3_2_3b"):
        specs = TSH.param_pspecs(TB.get_config(arch), _tparams(arch), tm)
        assert specs["embed"][0] == "model"
        stack = specs["dec_layers" if arch == "whisper_small" else "layers"]
        assert stack["attn"]["wk"] == TSH.P(None, ("data",), "model")
    cfg = TB.get_config("internlm2_1_8b").replace(decode_cache_shard="seq")
    specs = TSH.cache_pspecs(cfg, TST.cache_specs(
        cfg, TB.INPUT_SHAPES["decode_32k"]), tm)
    assert specs["k"][2] == "model"
    assert specs["k"][3] is None and specs["k"][4] is None
    for arch in TB.ARCH_IDS:
        assert TB.get_config(arch).padded_vocab % 16 == 0


def test_abstract_inputs_allocate_nothing():
    for arch in ("grok_1_314b", "whisper_small", "internvl2_2b"):
        cfg = TB.get_config(arch)
        for shape in TB.INPUT_SHAPES.values():
            if TB.skip_reason(arch, shape.name):
                continue
            leaves = [x for _, x in tree_flatten_with_path(
                TST.input_specs(cfg, shape))]
            assert leaves and all(x.is_meta for x in leaves
                                  if hasattr(x, "is_meta"))


_FAKE_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import base
from repro_torch.launch import sharding as SH, steps as ST
from repro_torch.launch.mesh import make_production_mesh
multi = sys.argv[2] == "1"
world = 512 if multi else 256
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
mesh = make_production_mesh(multi_pod=multi, device="cpu")
cfg = base.get_config("mixtral_8x7b")
shapes = ST.params_specs(cfg)
specs = SH.param_pspecs(cfg, shapes, mesh)
out = {}
with FakeTensorMode():
    placed = SH.distribute_tree(shapes, specs, mesh)
for path in (("embed",), ("layers", "attn", "wq"), ("layers", "moe", "w_down"),
             ("final_norm", "scale")):
    x = placed
    for k in path:
        x = x[k]
    out["/".join(path)] = {"placements": [f"S{p.dim}" if p.is_shard() else "R"
                                          for p in x.placements],
                           "local": list(x.to_local().shape),
                           "global": list(x.shape)}
try:
    make_production_mesh(multi_pod=not multi, device="cpu")
except (RuntimeError, ValueError) as e:
    out["other"] = str(e)
print(json.dumps(out))
"""


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_placements_on_a_fake_group(multi_pod):
    """On the production mesh over a fake group: the placements of the
    spec, each rank holding the even shard (no allocation), and the
    other production mesh refused by its rank count."""
    out = subprocess.run(
        [sys.executable, "-c", _FAKE_CHILD, os.path.join(ROOT, "src"),
         "1" if multi_pod else "0"], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if multi_pod:
        assert got["embed"]["placements"] == ["S1", "S1", "S0"]
        assert got["embed"]["local"] == [32000 // 16, 4096 // 32]
        assert got["layers/attn/wq"]["local"] == [32, 4096 // 32, 4096 // 16]
        assert "wants 256 ranks of a world of 512" in got["other"]
    else:
        assert got["embed"]["placements"] == ["S1", "S0"]
        assert got["embed"]["local"] == [32000 // 16, 4096 // 16]
        assert got["layers/attn/wq"]["local"] == [32, 4096 // 16, 4096 // 16]
        assert got["layers/moe/w_down"]["local"] == [32, 8, 14336 // 16,
                                                     4096 // 16]
        assert "needs 512 ranks" in got["other"]
        assert "dryrun" in got["other"]
    assert got["final_norm/scale"]["local"] == [4096]
