"""The port's LM training slice against the JAX package, at the reduced
configs (2 layers, d_model 128, vocab 512; split depth 1).

- ``launch.steps.make_train_step``: two steps of the dense (Llama), ssm
  (Mamba2) and hybrid (Hymba) families, with 1 and 2 microbatches, under
  ``adamw`` and ``sgd``, against the live (jitted) JAX step from the same
  weights and batches: the step metrics (``loss_client``, ``loss_server``,
  ``w_client``, ``aux``) within 1e-5 and every parameter within 1e-4;
- the ssm family with ``use_pallas=True``: the reference runs its Pallas
  ``fuse_2d`` in interpret mode, the port its ``fuse`` wrapper (its plain
  version on the CPU), and the port's ``ssd_scan`` is never called (the
  scan records a gradient); the attention families with
  ``use_pallas=True`` raise in both packages (no flash backward);
- ``cfg.remat``: each layer checkpointed, recomputed in each of TPGF's
  two backward passes through the one prefix graph, and the gradients
  bit for bit those of the un-checkpointed graph;
- ``core.tpgf.local_only_grads``, ``models.model.full_loss`` and the
  ``split_params``/``merge_params`` views of an LM tree against the
  reference;
- bf16: the Phase-1 clip, Eq. 4 (both routes) and the AdamW update (fp32
  and bf16 moments) and SGD bit for bit against the reference on the same
  bf16 numpy inputs;
- ``python -m repro_torch.launch.train --reduced --device cpu`` and the
  ``examples/train_lm_supersfl_torch.py`` command.

The weights are the reference's ``init_params``, every leaf nudged by
N(0, 0.02²) (so the zero-initialised leaves shape the output too), carried
across with ``bridge.to_model_params``; the batches are
``synthetic_lm_batches`` (the same numpy draws in both packages).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402,E501
from repro.models import model as JM  # noqa: E402
from repro import optim as JO  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm_batches  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SS  # noqa: E402
from repro_torch.kernels.tpgf_fusion import ops as FO  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path, tree_get,  # noqa: E402
                              tree_map)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["llama3_2_3b", "mamba2_2_7b", "hymba_1_5b"]
METRIC_TOL = 1e-5
PARAM_TOL = 1e-4
BATCH, SEQ, STEPS = 4, 16, 2
OPTS = {"adamw": (lambda: JO.adamw(1e-3, weight_decay=0.1),
                  lambda: TO.adamw(1e-3, weight_decay=0.1)),
        "sgd": (lambda: JO.sgd(0.1), lambda: TO.sgd(0.1))}


@pytest.fixture(scope="module")
def weights():
    """arch -> the reference's nudged weights as numpy (built once)."""
    out = {}
    for arch in ARCHS:
        p = JM.init_params(JB.get_reduced(arch), jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        out[arch] = jax.tree.map(
            lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(
                x.shape)).astype(np.float32), p)
    return out


def _batches(vocab, n=STEPS):
    return list(synthetic_lm_batches(vocab, SEQ, BATCH, n, seed=1))


def _flat_jax(tree):
    return {tuple(k.key for k in p): np.asarray(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_params_close(jtree, ttree, tol=PARAM_TOL):
    want = _flat_jax(jtree)
    got = {p: x.detach().float().numpy()
           for p, x in tree_flatten_with_path(ttree)}
    assert sorted(want) == sorted(got)
    for path, x in want.items():
        np.testing.assert_allclose(got[path], x, rtol=0, atol=tol,
                                   err_msg=str(path))


def _run_both(weights, arch, mb, opt, use_pallas=False):
    """STEPS steps of the JAX step (jitted) and the port's; returns their
    metric records and final params."""
    jcfg = JB.get_reduced(arch).replace(microbatches=mb,
                                        use_pallas=use_pallas)
    tcfg = TB.get_reduced(arch).replace(microbatches=mb,
                                        use_pallas=use_pallas)
    jopt, topt = (f() for f in OPTS[opt])
    jstep, _ = j_make_train_step(jcfg, jopt)
    jstep = jax.jit(jstep)
    tstep, _ = TSTEPS.make_train_step(tcfg, topt)
    jp = jax.tree.map(jnp.asarray, weights[arch])
    tp = bridge.to_model_params(tcfg, weights[arch], device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jrec, trec = [], []
    for b in _batches(tcfg.vocab):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        jrec.append({k: float(v) for k, v in jm.items()})
        trec.append({k: float(v) for k, v in tm.items()})
    return jrec, trec, jp, tp


def _assert_metrics_close(jrec, trec):
    assert [sorted(r) for r in trec] == [
        ["aux", "loss_client", "loss_server", "w_client"]] * len(jrec)
    for j, t in zip(jrec, trec):
        for k in j:
            assert abs(j[k] - t[k]) <= METRIC_TOL, (k, j[k], t[k])


# ------------------------------------------------------- make_train_step

@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(weights, arch, mb, opt):
    jrec, trec, jp, tp = _run_both(weights, arch, mb, opt)
    _assert_metrics_close(jrec, trec)
    _assert_params_close(jp, tp)


@pytest.mark.parametrize("mb", [1, 2])
def test_ssm_with_use_pallas_fuses_through_the_wrapper_not_the_scan(
        weights, monkeypatch, mb):
    """The reference runs Eq. 4 through its Pallas ``fuse_2d`` (interpret
    mode); the port through ``fuse_leaf`` once per client leaf and
    microbatch; the port's ``ssd_scan`` is never called."""
    calls = {"fuse": 0, "scan": 0}
    real_fuse = FO.fuse_leaf

    def fuse_spy(*a, **k):
        calls["fuse"] += 1
        return real_fuse(*a, **k)

    def scan_spy(*a, **k):
        calls["scan"] += 1
        raise AssertionError("ssd_scan called while recording a gradient")

    monkeypatch.setattr(FO, "fuse_leaf", fuse_spy)
    monkeypatch.setattr(SS, "ssd_scan", scan_spy)
    jrec, trec, jp, tp = _run_both(weights, "mamba2_2_7b", mb, "adamw",
                                   use_pallas=True)
    _assert_metrics_close(jrec, trec)
    _assert_params_close(jp, tp)
    cfg = TB.get_reduced("mamba2_2_7b")
    n_client = len(tree_flatten_with_path(TSN.split_params(
        cfg, TM.init_params(cfg, None, device="meta"),
        cfg.resolved_split_depth)[0]))
    assert calls == {"fuse": STEPS * mb * n_client, "scan": 0}


@pytest.mark.parametrize("arch", ["llama3_2_3b", "hymba_1_5b"])
def test_attention_families_with_use_pallas_raise_in_both_packages(
        weights, arch):
    b = _batches(512, 1)[0]
    jcfg = JB.get_reduced(arch).replace(use_pallas=True)
    jstep, jopt = j_make_train_step(jcfg, JO.sgd(0.1))
    jp = jax.tree.map(jnp.asarray, weights[arch])
    with pytest.raises(Exception):          # no VJP through the kernel
        jstep(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    with pytest.raises(NotImplementedError, match="no backward"):
        TSTEPS.make_train_step(TB.get_reduced(arch).replace(use_pallas=True))


def test_default_optimizer_is_adamw_with_the_configs_moment_dtype():
    cfg = TB.get_reduced("mamba2_2_7b").replace(
        adam_moment_dtype="bfloat16")
    _, opt = TSTEPS.make_train_step(cfg)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = opt.init(p)
    assert sorted(state) == ["m", "t", "v"]
    assert state["m"]["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moment dtype"):
        TO.adamw(1e-3, moment_dtype="float16")


def test_train_step_refuses_a_batch_the_microbatches_do_not_divide():
    cfg = TB.get_reduced("mamba2_2_7b").replace(microbatches=3)
    step, opt = TSTEPS.make_train_step(cfg, TO.sgd(0.1))
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.as_tensor(v) for k, v in _batches(512, 1)[0].items()}
    with pytest.raises(ValueError, match="microbatches=3"):
        step(p, opt.init(p), b)


# ----------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_each_layer_and_keeps_gradients_bit_exact(
        weights, monkeypatch, arch):
    """With ``remat`` the client layers run three times (the forward and
    one recompute in each of the two backward passes through the prefix
    graph) and the server layer twice; every gradient equals the
    un-checkpointed graph's bit for bit."""
    cfg = TB.get_reduced(arch)
    params = bridge.to_model_params(cfg, weights[arch], device="cpu")
    b = {k: torch.as_tensor(v) for k, v in _batches(512, 1)[0].items()}
    d = cfg.resolved_split_depth
    real, calls = TM._layer, []

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TM, "_layer", counting)
    outs = {}
    for remat in (False, True):
        calls.clear()
        outs[remat] = TT.tpgf_grads(cfg.replace(remat=remat), params, b, d)
        outs[remat] = (outs[remat], len(calls))
    (plain, n_plain), (ckpt, n_ckpt) = outs[False], outs[True]
    L = cfg.n_layers
    assert n_plain == L and n_ckpt == 3 * d + 2 * (L - d)
    for k in ("loss_client", "loss_server", "w_client"):
        assert torch.equal(getattr(plain, k), getattr(ckpt, k))
    for path, g in tree_flatten_with_path(plain.grads):
        assert torch.equal(g, tree_get(ckpt.grads, path)), path


def test_remat_is_off_without_a_gradient(weights, monkeypatch):
    """Serving (no grad mode) never checkpoints."""
    cfg = TB.get_reduced("llama3_2_3b").replace(remat=True)
    params = bridge.to_model_params(cfg, weights["llama3_2_3b"],
                                    device="cpu")
    seen = []
    monkeypatch.setattr(TM, "checkpoint",
                        lambda *a, **k: seen.append(1) or a[0](*a[1:3]))
    b = {k: torch.as_tensor(v) for k, v in _batches(512, 1)[0].items()}
    with torch.no_grad():
        TM.full_loss(cfg, params, b)
    assert not seen
    TM.full_loss(cfg, params, b)
    assert len(seen) == cfg.n_layers


def test_departure_f_scan_gradient_is_finite_where_the_reference_overflows():
    """``ssd_chunked`` with dt·|A| summing past ~88 over a chunk: the
    reference's backward is NaN (exp of the unmasked upper half is inf,
    and inf·0 = NaN), the port's is finite; the forward is the same on
    both sides, and where the reference's gradient is finite (a small
    dt) the port's equals it."""
    from repro.models.ssm import ssd_chunked as j_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked as t_scan
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 64, 2, 4)).astype(np.float32)
    A = -np.array([1.0, 16.0], np.float32)
    Bm = rng.standard_normal((1, 64, 3)).astype(np.float32)
    Cm = rng.standard_normal((1, 64, 3)).astype(np.float32)
    for dt_value, reference_finite in ((2.0, False), (0.01, True)):
        dt = np.full((1, 64, 2), dt_value, np.float32)

        def j_loss(dt_):
            return j_scan(jnp.asarray(x), dt_, jnp.asarray(A), jnp.asarray(Bm),
                          jnp.asarray(Cm), chunk=64)[0].sum()

        j_y = j_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                     chunk=64)[0]
        j_g = np.asarray(jax.grad(j_loss)(jnp.asarray(dt)))
        t_dt = torch.tensor(dt, requires_grad=True)
        t_y, _ = t_scan(torch.tensor(x), t_dt, torch.tensor(A),
                        torch.tensor(Bm), torch.tensor(Cm), chunk=64)
        t_y.sum().backward()
        np.testing.assert_allclose(t_y.detach().numpy(), np.asarray(j_y),
                                   rtol=2e-5, atol=2e-5)
        assert bool(np.isfinite(j_g).all()) == reference_finite
        assert bool(torch.isfinite(t_dt.grad).all())
        if reference_finite:
            np.testing.assert_allclose(t_dt.grad.numpy(), j_g, rtol=2e-5,
                                       atol=2e-5)


# ------------------------------------------ local-only step, loss, views

@pytest.mark.parametrize("arch", ARCHS)
def test_local_only_grads_matches_reference(weights, arch):
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    b = _batches(512, 1)[0]
    d = tcfg.resolved_split_depth
    jg, jl = JT.local_only_grads(jcfg, jax.tree.map(jnp.asarray,
                                                    weights[arch]),
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 d)
    tg, tl = TT.local_only_grads(
        tcfg, bridge.to_model_params(tcfg, weights[arch], device="cpu"),
        {k: torch.as_tensor(v) for k, v in b.items()}, d)
    assert abs(float(jl) - float(tl)) <= METRIC_TOL
    _assert_params_close(jg, tg, tol=1e-5)
    # the server branch gets exactly zero
    assert not tg["unembed"].any() and not tg["final_norm"]["scale"].any()
    assert all(not x[d:].any() for _, x in
               tree_flatten_with_path(tg["layers"]))


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_loss_matches_reference(weights, arch, valid):
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    b = _batches(512, 1)[0]
    if valid:      # a ragged mask: the valid-weighted mean
        b["valid"] = (np.arange(SEQ)[None, :]
                      < np.array([[SEQ], [3], [0], [9]])).astype(np.int32)
    want = JM.full_loss(jcfg, jax.tree.map(jnp.asarray, weights[arch]),
                        {k: jnp.asarray(v) for k, v in b.items()})
    got = TM.full_loss(
        tcfg, bridge.to_model_params(tcfg, weights[arch], device="cpu"),
        {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(want) - float(got)) <= METRIC_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_split_and_merge_views_of_an_lm_tree_match_reference(weights, arch):
    """``embed`` goes to the client, ``final_norm`` and ``unembed`` to
    the server, ``local_head`` to local; the stack splits at ``d``; merge
    restores the tree."""
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    d = tcfg.resolved_split_depth
    jviews = JSN.split_params(jcfg, jax.tree.map(jnp.asarray,
                                                 weights[arch]), d)
    tp = bridge.to_model_params(tcfg, weights[arch], device="cpu")
    tviews = TSN.split_params(tcfg, tp, d)
    assert sorted(tviews[0]) == ["embed", "layers"]
    assert sorted(tviews[1]) == ["final_norm", "layers", "unembed"]
    assert sorted(tviews[2]) == ["local_head"]
    for jv, tv in zip(jviews, tviews):
        _assert_params_close(jv, tv, tol=0)
    merged = TSN.merge_params(tcfg, *tviews)
    for path, x in tree_flatten_with_path(tp):
        assert torch.equal(x, tree_get(merged, path)), path


# ------------------------------------------------------------------ bf16

def _bf16_tree(rng, shapes, scale):
    return {k: (_bf16_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(ml_dtypes.bfloat16))
            for k, v in shapes.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch_bf16(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        a.view(np.int16).copy()).view(torch.bfloat16), tree)


def _assert_bits_equal(jtree, ttree):
    want = {tuple(k.key for k in p): np.asarray(x).view(np.int16)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {p: x.view(torch.int16).numpy()
           for p, x in tree_flatten_with_path(ttree)}
    assert sorted(want) == sorted(got)
    for path, x in want.items():
        differ = int((got[path] != x).sum())
        assert differ == 0, f"{path}: {differ} of {x.size} differ"


def test_bf16_clip_fusion_and_optimizer_updates_bit_for_bit():
    """On the reduced ssm config's client-view shapes in bf16: the Phase-1
    clip (its norm is summed in each framework's own order, so the two
    norms agree to a few fp32 ulps; the scaled leaves bit for bit), Eq. 4
    on both routes, three AdamW steps (fp32 and bf16 moments, weight
    decay) and an SGD step, each on the same bf16 inputs."""
    cfg = TB.get_reduced("mamba2_2_7b").replace(dtype="bfloat16")
    client = TSN.split_params(cfg, TM.init_params(cfg, None, device="meta"),
                              cfg.resolved_split_depth)[0]
    shapes = tree_map(lambda x: tuple(x.shape), client)
    rng = np.random.default_rng(3)
    g_local = _bf16_tree(rng, shapes, 0.05)
    g_server = _bf16_tree(rng, shapes, 0.05)
    jc, jn = JT.clip_by_global_l2(_to_jax(g_local), cfg.tpgf_clip)
    tc, tn = TT.clip_by_global_l2(_to_torch_bf16(g_local), cfg.tpgf_clip)
    assert float(jn) > cfg.tpgf_clip       # the clip scales
    assert abs(float(jn) - float(tn)) <= 2e-6 * float(jn)
    _assert_bits_equal(jc, tc)
    w = 0.2477
    for use_pallas in (False, True):
        _assert_bits_equal(
            JT.fuse_gradients(jc, _to_jax(g_server), jnp.float32(w),
                              use_pallas=use_pallas),
            TT.fuse_gradients(tc, _to_torch_bf16(g_server),
                              torch.tensor(w), use_pallas=use_pallas))
    params = _bf16_tree(rng, shapes, 0.02)
    grads = [_bf16_tree(rng, shapes, 0.01) for _ in range(3)]
    for md in ("float32", "bfloat16"):
        jopt = JO.adamw(1e-3, weight_decay=0.1, moment_dtype=jnp.dtype(md))
        topt = TO.adamw(1e-3, weight_decay=0.1, moment_dtype=md)
        jp, tp = _to_jax(params), _to_torch_bf16(params)
        tp_whole = _to_torch_bf16(params)
        js, ts, ts_whole = jopt.init(jp), topt.init(tp), topt.init(tp_whole)
        for g in grads:
            upd, js = jopt.update(_to_jax(g), js, jp)
            jp = JO.apply_updates(jp, upd)
            tp, ts = TSTEPS.apply_in_place(topt, _to_torch_bf16(g), ts, tp)
            tupd, ts_whole = topt.update(_to_torch_bf16(g), ts_whole,
                                         tp_whole)
            tp_whole = TO.apply_updates(tp_whole, tupd)
            _assert_bits_equal(jp, tp)
            _assert_bits_equal(jp, tp_whole)
            if md == "bfloat16":
                _assert_bits_equal(js["m"], ts["m"])
                _assert_bits_equal(js["v"], ts["v"])
        assert int(ts["t"]) == 3
    jp, tp = _to_jax(params), _to_torch_bf16(params)
    upd, _ = JO.sgd(0.1).update(_to_jax(grads[0]), (), jp)
    tp, _ = TSTEPS.apply_in_place(TO.sgd(0.1), _to_torch_bf16(grads[0]), (),
                                  tp)
    _assert_bits_equal(JO.apply_updates(jp, upd), tp)


# --------------------------------------------------- launcher and example

def test_train_launcher_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    hist = TTRAIN.main(["--arch", "mamba2_2_7b", "--reduced", "--device",
                        "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
                        "--log-every", "2", "--ckpt", ck])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=mamba2-reduced") and "split_depth=1/2" \
        in out[0]
    recs = [json.loads(ln) for ln in out if ln.startswith("{")]
    assert recs == hist and [r["step"] for r in recs] == [1, 2, 4]
    assert all(sorted(r) == ["aux", "elapsed_s", "loss_client",
                             "loss_server", "step", "w_client"]
               for r in recs)
    assert out[-1].startswith("loss_server ")
    # the reference's loader reads the port's checkpoint
    tree, manifest = j_load(ck)
    assert manifest["step"] == 4 and manifest["meta"] == {
        "arch": "mamba2-reduced"}
    assert tree["embed"].shape == (512, 128)
    # --mesh 1x1: one rank in this process, bit for bit the meshless run
    capsys.readouterr()
    meshed = TTRAIN.main(["--arch", "mamba2_2_7b", "--reduced", "--device",
                          "cpu", "--steps", "4", "--batch", "4", "--seq",
                          "16", "--log-every", "2", "--mesh", "1x1"])
    assert [{k: v for k, v in r.items() if k != "elapsed_s"}
            for r in meshed] == [{k: v for k, v in r.items()
                                  if k != "elapsed_s"} for r in hist]
    assert "mesh=" in capsys.readouterr().out.splitlines()[0]
    # --mesh alone is the production mesh: 256 ranks or none
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        TTRAIN.main(["--mesh", "--reduced", "--device", "cpu"])


def test_train_launcher_full_config_keeps_its_dtype():
    cfg = TTRAIN.train_config("mamba2_2_7b", reduced=False)
    assert (cfg.dtype, cfg.microbatches, cfg.remat) == ("bfloat16", 1, True)
    cfg = TTRAIN.train_config("llama3_2_3b", reduced=True)
    assert (cfg.dtype, cfg.microbatches) == ("float32", 1)


def test_train_example_runs_the_launcher(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "train_lm_supersfl_torch",
        ROOT / "examples" / "train_lm_supersfl_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    monkeypatch.setattr(mod.subprocess, "call",
                        lambda cmd, **kw: seen.update(cmd=cmd, **kw) or 0)
    assert mod.main(["hymba_1_5b", "--device", "cpu"]) == 0
    cmd = seen["cmd"]
    assert cmd[1:3] == ["-m", "repro_torch.launch.train"]
    assert cmd[cmd.index("--arch") + 1] == "hymba_1_5b"
    assert cmd[cmd.index("--device") + 1] == "cpu" and "--reduced" in cmd
