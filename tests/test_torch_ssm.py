"""The port's ssm (Mamba2) and hybrid (Hymba) families against the JAX
package, at the reduced configs (2 layers, d_model 128, vocab 512).

- the mixer alone in fp32: ``causal_conv``, ``ssm_apply`` (with its
  returned state) and ``ssm_decode_step`` on the same numpy inputs;
- whole models with the reference's weights (``bridge.to_model_params``,
  every leaf nudged by N(0, 0.05²) so the zero-initialised ``conv_b``,
  ``gate_norm_scale`` and the branch scales shape the output): prefill
  logits and cache (``ssm_h``, ``ssm_conv``, and ``k``/``v`` for Hymba),
  then ``decode_step`` logits and cache step by step;
- decode equals the teacher-forced prefill on the port alone
  (``tests/test_decode_parity.py``'s property and bound, 2e-3);
- departure (e): ``use_pallas`` sends every layer's scan through the
  ``ssd_scan`` wrapper and agrees with the plain route; departure (c)
  extended: ``decode_step`` writes ``ssm_h`` and ``ssm_conv`` in place;
- bf16: the activations and the conv bit for bit, and the mixer within
  one bf16 ulp, so that a cast in the wrong place shows;
- ``init_params`` against the reference's shapes, dtypes and
  distributions, and the full-size parameter counts on the meta device;
- ``examples/serve_decode_torch.py`` serving both families on the CPU.

fp32 tolerance 2e-5, as the dense slice's (the frameworks sum matmuls in
other orders).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated import Engine  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SS  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["mamba2_2_7b", "hymba_1_5b"]
TOL = dict(rtol=2e-5, atol=2e-5)
B = 2
PROMPT, BUDGET, TOTAL = 12, 8, 18


def _np(x):
    """A numpy copy (the port's cache is written in place later)."""
    return x.detach().float().cpu().numpy().copy() \
        if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _perturbed(arch, seed=0):
    """The reference's init for the reduced ``arch``, every leaf nudged by
    N(0, 0.05²); as numpy arrays."""
    jp = JM.init_params(JB.get_reduced(arch), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)


def _tokens(S, seed=4):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _mixer(arch, dtype="float32"):
    """Reduced configs, and layer 0's mixer params on both sides."""
    jcfg = JB.get_reduced(arch).replace(dtype=dtype)
    tcfg = TB.get_reduced(arch).replace(dtype=dtype)
    np_p = jax.tree.map(lambda x: x[0], _perturbed(arch)["layers"]["ssm"])
    jp = {k: jnp.asarray(v, dtype) for k, v in np_p.items()}
    tp = {k: torch.tensor(v).to(TM.torch_dtype(tcfg))
          for k, v in np_p.items()}
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------ the mixer

def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    want = JS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TS.causal_conv(*(torch.tensor(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [32, 256], ids=["chunk32", "one-chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_apply_matches_reference(arch, chunk):
    """Output, final state and conv tail; chunk 32 scans S = 64 in two
    chunks, 256 falls back to one."""
    jcfg, tcfg, jp, tp = _mixer(arch)
    x = np.random.default_rng(1).normal(size=(B, 64, 128)).astype(np.float32)
    want = JS.ssm_apply(jcfg, jp, jnp.asarray(x), chunk=chunk,
                        return_state=True)
    with torch.no_grad():
        got = TS.ssm_apply(tcfg, tp, torch.tensor(x), chunk=chunk,
                           return_state=True)
        plain = TS.ssm_apply(tcfg, tp, torch.tensor(x), chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    assert torch.equal(plain, got[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_step_matches_reference(arch):
    jcfg, tcfg, jp, tp = _mixer(arch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 1, 128)).astype(np.float32)
    h = rng.normal(0, 0.1, (B, jcfg.ssm_n_heads, jcfg.ssm_head_dim,
                            jcfg.ssm_state)).astype(np.float32)
    conv = rng.normal(size=(B, 3, jcfg.ssm_d_inner)).astype(np.float32)
    wy, wst = JS.ssm_decode_step(jcfg, jp, jnp.asarray(x), {
        "h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    state = {"h": torch.tensor(h), "conv": torch.tensor(conv)}
    gy, gst = TS.ssm_decode_step(tcfg, tp, torch.tensor(x), state)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **TOL)
    np.testing.assert_allclose(_np(gst["h"]), np.asarray(wst["h"]), **TOL)
    np.testing.assert_allclose(_np(gst["conv"]), np.asarray(wst["conv"]),
                               **TOL)
    np.testing.assert_array_equal(state["h"].numpy(), h)  # not written
    init = TS.ssm_decode_init(tcfg, 3, torch.float32, "cpu")
    jinit = JS.ssm_decode_init(jcfg, 3, jnp.float32)
    for key in ("h", "conv"):
        assert tuple(init[key].shape) == jinit[key].shape
        assert not init[key].any()


# ------------------------------------------------------ the whole model

def _run_jax(arch, np_p, toks):
    jcfg = JB.get_reduced(arch)
    jp = jax.tree.map(jnp.asarray, np_p)
    logits, cache = JD.prefill(jcfg, jp, {"tokens": jnp.asarray(
        toks[:, :PROMPT])}, decode_budget=BUDGET)
    out = [(np.asarray(logits),
            {k: np.asarray(v) for k, v in cache.items() if k != "idx"})]
    step = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
    for t in range(PROMPT, TOTAL):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]))
        out.append((np.asarray(lg), {k: np.asarray(v) for k, v in
                                     cache.items() if k != "idx"}))
    return out


def _run_port(tcfg, tp, toks):
    with torch.no_grad():
        logits, cache = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, decode_budget=BUDGET)
        out = [(_np(logits), {k: _np(v) for k, v in cache.items()
                              if k != "idx"})]
        for t in range(PROMPT, TOTAL):
            lg, cache = TD.decode_step(tcfg, tp, cache, torch.as_tensor(
                toks[:, t:t + 1]))
            out.append((_np(lg), {k: _np(v) for k, v in cache.items()
                                  if k != "idx"}))
    return out


@pytest.fixture(scope="module")
def step_by_step():
    """Per arch: the reference's and the port's prefill (12 tokens,
    budget 8) and 6 teacher-forced decode steps."""
    out = {}
    for arch in ARCHS:
        np_p = _perturbed(arch)
        toks = _tokens(TOTAL)
        tp = bridge.to_model_params(TB.get_reduced(arch), np_p,
                                     device="cpu")
        out[arch] = (_run_jax(arch, np_p, toks),
                     _run_port(TB.get_reduced(arch), tp, toks))
    return out


@pytest.mark.parametrize("step", range(TOTAL - PROMPT + 1))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(step_by_step, arch, step):
    """Step 0 is the prefill; then one decode step each."""
    want, got = step_by_step[arch]
    (wl, wc), (gl, gc) = want[step], got[step]
    keys = {"mamba2_2_7b": {"pos", "ssm_h", "ssm_conv"},
            "hymba_1_5b": {"pos", "k", "v", "ssm_h", "ssm_conv"}}[arch]
    assert set(gc) == set(wc) == keys
    np.testing.assert_allclose(gl, wl, **TOL)
    for key in keys:
        assert gc[key].shape == wc[key].shape, key
        np.testing.assert_allclose(gc[key], wc[key], err_msg=key, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced(arch, use_pallas):
    """The port alone: decode logits == the full prefill's, position by
    position (``test_decode_parity.py``'s property and bound)."""
    tcfg = TB.get_reduced(arch).replace(use_pallas=use_pallas)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(2),
                        device="cpu")
    toks = _tokens(TOTAL, seed=5)
    with torch.no_grad():
        full, _ = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    got = _run_port(tcfg, tp, toks)
    pred = np.stack([got[0][0][:, -1]] + [g[0][:, 0] for g in got[1:-1]],
                    axis=1)
    want = _np(full)[:, PROMPT - 1:TOTAL - 1]
    assert np.max(np.abs(pred - want)) / (np.abs(want).max() + 1e-9) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_departure_e_use_pallas_routes_the_scan_through_the_wrapper(
        monkeypatch, arch):
    """Under ``use_pallas`` every layer's prefill scan goes through
    ``ssd_scan`` (here on its plain version, chunk 32, so S = 64 scans in
    two chunks where the plain route takes one) and agrees with the
    plain route and the reference."""
    calls = []
    real = SS.ssd_scan

    def spy(x, dt, A, B_, C, D=None):
        calls.append(tuple(x.shape))
        return real(x, dt, A, B_, C, D)

    monkeypatch.setattr(SS, "ssd_scan", spy)
    np_p = _perturbed(arch)
    toks = _tokens(64, seed=6)
    jcfg = JB.get_reduced(arch)
    want, _ = JD.prefill(jcfg, jax.tree.map(jnp.asarray, np_p),
                         {"tokens": jnp.asarray(toks)})
    out = {}
    for use_pallas in (False, True):
        tcfg = TB.get_reduced(arch).replace(use_pallas=use_pallas)
        tp = bridge.to_model_params(tcfg, np_p, device="cpu")
        with torch.no_grad():
            out[use_pallas], _ = TD.prefill(
                tcfg, tp, {"tokens": torch.as_tensor(toks)})
    assert calls == [(B, 64, tcfg.ssm_n_heads, tcfg.ssm_head_dim)] \
        * tcfg.n_layers
    np.testing.assert_allclose(_np(out[True]), _np(out[False]), **TOL)
    np.testing.assert_allclose(_np(out[True]), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_departure_c_decode_writes_the_ssm_state_in_place(arch):
    tcfg = TB.get_reduced(arch)
    tp = bridge.to_model_params(tcfg, _perturbed(arch), device="cpu")
    toks = _tokens(10)
    with torch.no_grad():
        _, cache = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :8])}, decode_budget=4)
        buffers = {k: (cache[k], cache[k].data_ptr())
                   for k in cache if k != "idx"}
        before = {k: cache[k].clone() for k in ("ssm_h", "ssm_conv")}
        _, new = TD.decode_step(tcfg, tp, cache, torch.as_tensor(
            toks[:, 8:9]))
    assert new is cache
    for key, (t, ptr) in buffers.items():
        assert new[key] is t and new[key].data_ptr() == ptr, key
    for key, old in before.items():      # every layer's state moved
        for i in range(tcfg.n_layers):
            assert not torch.equal(new[key][i], old[i]), (key, i)
    if "k" not in cache:                 # the ssm family never writes pos
        assert new["pos"][:, 8:].eq(-1).all()


def test_init_cache_matches_reference():
    for arch in ARCHS:
        want = JD.init_cache(JB.get_reduced(arch), 3, 40)
        got = TD.init_cache(TB.get_reduced(arch), 3, 40, device="cpu")
        assert set(got) == set(want)
        for key in set(want) - {"idx"}:
            assert tuple(got[key].shape) == want[key].shape, key
            assert str(got[key].dtype)[6:] == str(want[key].dtype), key
            np.testing.assert_array_equal(_np(got[key]),
                                          np.asarray(want[key], np.float32))
        assert got["idx"] == int(want["idx"]) == 0


# --------------------------------------------------------------- bf16

def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def test_bf16_activations_and_conv_match_reference_bit_for_bit():
    """The bf16 ops whose rounding the casts decide: silu (the sigmoid
    rounded, then the product), softplus (``logaddexp``'s ops, each
    rounded), the causal conv (k rounded products summed from 0) and the
    decode's conv einsum."""
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng.normal(0, 3, (4, 64, 256)).astype(np.float32))
    assert torch.equal(TL.silu(tx).float(),
                       torch.tensor(np.asarray(jax.nn.silu(jx), np.float32)))
    assert torch.equal(TS._softplus(tx).float(), torch.tensor(
        np.asarray(jax.nn.softplus(jx), np.float32)))
    jw, tw = _bf16(rng.normal(0, 0.1, (4, 256)).astype(np.float32))
    jb, tb = _bf16(rng.normal(0, 0.1, (256,)).astype(np.float32))
    assert torch.equal(TS.causal_conv(tx, tw, tb).float(), torch.tensor(
        np.asarray(JS.causal_conv(jx, jw, jb), np.float32)))
    jwin, twin = _bf16(rng.normal(size=(4, 4, 256)).astype(np.float32))
    assert torch.equal(
        torch.einsum("bkd,kd->bd", twin, tw).float(),
        torch.tensor(np.asarray(jnp.einsum("bkd,kd->bd", jwin, jw),
                                np.float32)))


def _within_one_ulp_of_each_row(got, want):
    """|got − want| <= one bf16 ulp (8 significant bits) of each row's
    largest |want|: a row is one token's output, and a tie that rounds the
    other way upstream (the fp32 scan sums in another order) moves the
    whole row by a fraction of that ulp, while a misplaced cast moves it
    by more."""
    got = _np(got).reshape(want.shape[0], want.shape[1], -1)
    want = np.asarray(want, np.float32).reshape(got.shape)
    top = np.abs(want).max(axis=-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    err = np.abs(got - want)
    assert np.all(err <= ulp), float((err / ulp).max())


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_mixer_within_one_ulp_of_reference(arch, step):
    jcfg, tcfg, jp, tp = _mixer(arch, "bfloat16")
    rng = np.random.default_rng(4)
    S = 64 if step == "prefill" else 1
    jx, tx = _bf16(rng.normal(size=(B, S, 128)).astype(np.float32))
    if step == "prefill":
        want, _, wconv = JS.ssm_apply(jcfg, jp, jx, return_state=True)
        with torch.no_grad():
            got, _, gconv = TS.ssm_apply(tcfg, tp, tx, return_state=True)
    else:
        h = rng.normal(0, 0.1, (B, jcfg.ssm_n_heads, jcfg.ssm_head_dim,
                                jcfg.ssm_state)).astype(np.float32)
        jc, tc = _bf16(rng.normal(size=(B, 3, jcfg.ssm_d_inner)).astype(
            np.float32))
        want, wst = JS.ssm_decode_step(jcfg, jp, jx,
                                       {"h": jnp.asarray(h), "conv": jc})
        got, gst = TS.ssm_decode_step(tcfg, tp, tx,
                                      {"h": torch.tensor(h), "conv": tc})
        wconv, gconv = wst["conv"], gst["conv"]
    assert got.dtype == torch.bfloat16 and gconv.dtype == torch.bfloat16
    _within_one_ulp_of_each_row(got, want)
    np.testing.assert_array_equal(_np(gconv), np.asarray(wconv, np.float32))


# --------------------------------------------------------------- init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_and_distributions(arch):
    """Random leaves by their distribution; the constants (``dt_bias``,
    ``A_log``, ``D``, zeros, the branch scales) by value."""
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    want = {tuple(getattr(k, "key", k) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(
                JM.init_params(jcfg, jax.random.PRNGKey(0)))[0]}
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    got = {p: x for p, x in tree_flatten_with_path(tp)}
    assert sorted(got) == sorted(want)
    constants = {"dt_bias", "A_log", "D", "conv_b", "gate_norm_scale",
                 "branch_scale_attn", "branch_scale_ssm"}
    for path, x in got.items():
        ref = want[path]
        assert tuple(x.shape) == ref.shape, path
        assert str(x.dtype).replace("torch.", "") == str(ref.dtype), path
        if path[-1] in constants or not ref.any():
            np.testing.assert_allclose(x.numpy(), ref, rtol=1e-6,
                                       err_msg=str(path))
            continue
        y = x.numpy()
        assert abs(y.mean()) < 0.1 * ref.std(), path
        assert math.isclose(y.std(), ref.std(), rel_tol=0.05), path
    meta = TM.init_params(tcfg, None, device="meta")
    assert {p: tuple(x.shape) for p, x in tree_flatten_with_path(meta)} \
        == {p: tuple(x.shape) for p, x in got.items()}


@pytest.mark.parametrize("arch,fields,count", [
    ("mamba2_2_7b", (64, 2560, 5120, 80, 64, 128, 50280), 2_961_098_240),
    ("hymba_1_5b", (32, 1600, 3200, 50, 64, 16, 32001), 1_693_395_200),
])
def test_full_size_parameter_count(arch, fields, count):
    """At the published widths, on the meta device: the reference's count
    (from its shapes alone, ``jax.eval_shape``), bf16 throughout."""
    cfg = TB.get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.vocab) == fields
    meta = TM.init_params(cfg, None, device="meta")
    shapes = jax.eval_shape(lambda: JM.init_params(JB.get_config(arch),
                                                   jax.random.PRNGKey(0)))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert TM.param_count(meta) == want == count
    assert all(x.dtype == torch.bfloat16 for _, x in
               tree_flatten_with_path(meta))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_train_step_trains_these_families(arch):
    """``make_train_step`` takes a step of each family (held to the
    reference in ``tests/test_torch_lm_train.py``); the federated
    ``Engine`` still refuses an LM config and names the train step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import sgd
    cfg = TB.get_reduced(arch).replace(microbatches=B)
    with pytest.raises(NotImplementedError, match="make_train_step"):
        Engine(cfg, 3, "ssfl", device="cpu")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    before = {p: x.clone() for p, x in tree_flatten_with_path(params)}
    step, opt = make_train_step(cfg, sgd(0.5))
    toks = torch.as_tensor(_tokens(9))
    params, _, metrics = step(params, opt.init(params),
                              {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert 0.0 < float(metrics["w_client"]) < 1.0
    moved = [p for p, x in tree_flatten_with_path(params)
             if not torch.equal(x, before[p])]
    assert ("embed",) in moved and ("unembed",) in moved


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_on_the_cpu(capsys, arch):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = [arch, "--reduced", "--device", "cpu", "--prompt", "40",
            "--gen", "6"]
    gen = mod.main(argv)
    assert gen.shape == (4, 6) and gen.min() >= 0 and gen.max() < 512
    out = capsys.readouterr().out
    assert "generated=6 tokens" in out
    # an ssm cache has no attention window to report
    assert ("window=46" in out) == (arch == "hymba_1_5b")
    np.testing.assert_array_equal(gen, mod.main(argv))
