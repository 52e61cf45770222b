"""The port's KV-cache serving path against the JAX package, at the dense
configs' reduced forms (fp32).

- prefill + ``decode_step``, step by step: the cache's ``k``, ``v`` and
  ``pos`` and the logits after each step, for reduced Llama and Qwen
  (tolerance 2e-5, as the prefill parity);
- ``tests/test_decode_parity.py``'s property on the port alone: decode
  logits equal the teacher-forced prefill's (2e-3 of the largest logit,
  that test's bound);
- the rolling window (reduced Llama, ``sliding_window=16``, S = 24)
  against the JAX package;
- departures (c), the in-place cache, and (d), the host ``int`` index;
- ``make_prefill_step`` / ``make_serve_step`` and
  ``examples/serve_decode_torch.py --device cpu``.
"""
import importlib.util
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

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)
B = 2


def _np(x):
    """A numpy copy (the port's cache is written in place later)."""
    return x.detach().float().cpu().numpy().copy() \
        if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _params(arch, seed=0, **cfg_kw):
    jcfg = JB.get_reduced(arch).replace(**cfg_kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    np_p = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.05, x.shape).astype(np.float32), jp)
    tcfg = TB.get_reduced(arch).replace(**cfg_kw)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_p), \
        bridge.to_model_params(tcfg, np_p, device="cpu")


def _tokens(S, seed=4, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _run_jax(jcfg, jp, toks, n_prompt, budget):
    """The reference: prefill ``toks[:, :n_prompt]``, then decode the
    rest teacher-forced; per step (logits, k, v, pos)."""
    logits, cache = JD.prefill(jcfg, jp, {"tokens": jnp.asarray(
        toks[:, :n_prompt])}, decode_budget=budget)
    out = [(np.asarray(logits), np.asarray(cache["k"]),
            np.asarray(cache["v"]), np.asarray(cache["pos"]))]
    step = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
    for t in range(n_prompt, toks.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]))
        out.append((np.asarray(lg), np.asarray(cache["k"]),
                    np.asarray(cache["v"]), np.asarray(cache["pos"])))
    return out


def _run_port(tcfg, tp, toks, n_prompt, budget):
    with torch.no_grad():
        logits, cache = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :n_prompt])}, decode_budget=budget)
        out = [(_np(logits), _np(cache["k"]), _np(cache["v"]),
                cache["pos"].numpy().copy())]
        for t in range(n_prompt, toks.shape[1]):
            lg, cache = TD.decode_step(tcfg, tp, cache, torch.as_tensor(
                toks[:, t:t + 1]))
            out.append((_np(lg), _np(cache["k"]), _np(cache["v"]),
                        cache["pos"].numpy().copy()))
    return out, cache


@pytest.fixture(scope="module")
def step_by_step():
    """Per arch: the reference's and the port's prefill (12 tokens,
    budget 8) and 6 decode steps."""
    out = {}
    for arch in ("llama3_2_3b", "qwen2_5_3b"):
        jcfg, tcfg, jp, tp = _params(arch)
        toks = _tokens(18)
        out[arch] = (_run_jax(jcfg, jp, toks, 12, 8),
                     _run_port(tcfg, tp, toks, 12, 8)[0])
    return out


@pytest.mark.parametrize("step", range(7))
@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_5_3b"])
def test_decode_step_matches_reference(step_by_step, arch, step):
    want, got = step_by_step[arch]
    (wl, wk, wv, wp), (gl, gk, gv, gp) = want[step], got[step]
    assert gk.shape == wk.shape == (2, B, 20, 2, 32)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gl, wl, **TOL)
    np.testing.assert_allclose(gk, wk, **TOL)
    np.testing.assert_allclose(gv, wv, **TOL)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_5_3b", "gemma_2b",
                                  "internlm2_1_8b"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_matches_teacher_forced(arch, use_pallas):
    """The port alone: decode logits == the full prefill's, position by
    position (``test_decode_parity.py``'s property and bound)."""
    tcfg = TB.get_reduced(arch).replace(use_pallas=use_pallas)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(2),
                        device="cpu")
    S = 12
    toks = _tokens(S, seed=5)
    with torch.no_grad():
        full, _ = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    got, _ = _run_port(tcfg, tp, toks, S - 3, 8)
    pred = np.stack([got[0][0][:, -1]] + [g[0][:, 0] for g in got[1:-1]],
                    axis=1)
    want = _np(full)[:, S - 4:S - 1]
    assert np.max(np.abs(pred - want)) / (np.abs(want).max() + 1e-9) < 2e-3


def test_rolling_window_matches_reference():
    """sliding_window=16, S = 24: the prompt of 20 overflows the window,
    so the cache holds 16 rolled slots, and decode wraps around them."""
    jcfg, tcfg, jp, tp = _params("llama3_2_3b", sliding_window=16)
    toks = _tokens(24, seed=6)
    want = _run_jax(jcfg, jp, toks, 20, 0)
    got, _ = _run_port(tcfg, tp, toks, 20, 0)
    assert got[0][1].shape[2] == 16                    # rolling buffer
    for (wl, wk, wv, wp), (gl, gk, gv, gp) in zip(want, got):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gl, wl, **TOL)
        np.testing.assert_allclose(gk, wk, **TOL)
        np.testing.assert_allclose(gv, wv, **TOL)
    # and decode equals windowed attention over the whole sequence
    with torch.no_grad():
        full, _ = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    pred = np.stack([g[0][:, 0] for g in got[1:-1]], axis=1)
    want_full = _np(full)[:, 20:23]
    assert np.max(np.abs(pred - want_full)) / np.abs(want_full).max() < 2e-3


def test_cache_window_and_init_cache_match_reference():
    for arch, kw in (("llama3_2_3b", {}),
                     ("llama3_2_3b", {"sliding_window": 16})):
        jcfg = JB.get_reduced(arch).replace(**kw)
        tcfg = TB.get_reduced(arch).replace(**kw)
        for seq in (8, 16, 40, 70000):
            assert TD.cache_window(tcfg, seq) == JD.cache_window(jcfg, seq)
        want = JD.init_cache(jcfg, 3, 40)
        got = TD.init_cache(tcfg, 3, 40, device="cpu")
        for key in ("k", "v", "pos"):
            assert tuple(got[key].shape) == want[key].shape
            np.testing.assert_array_equal(_np(got[key]),
                                          np.asarray(want[key], np.float32))
        assert got["idx"] == int(want["idx"]) == 0


def test_departure_c_decode_writes_the_cache_in_place():
    _, tcfg, _, tp = _params("llama3_2_3b")
    toks = _tokens(10)
    with torch.no_grad():
        _, cache = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :8])}, decode_budget=4)
        buffers = {k: (cache[k], cache[k].data_ptr())
                   for k in ("k", "v", "pos")}
        before_k = cache["k"].clone()
        _, new = TD.decode_step(tcfg, tp, cache, torch.as_tensor(
            toks[:, 8:9]))
    assert new is cache
    for key, (t, ptr) in buffers.items():
        assert new[key] is t and new[key].data_ptr() == ptr, key
    # slot 8 was written, every other slot kept
    assert not torch.equal(new["k"][:, :, 8], before_k[:, :, 8])
    keep = [i for i in range(12) if i != 8]
    assert torch.equal(new["k"][:, :, keep], before_k[:, :, keep])
    assert new["pos"][:, 8].tolist() == [8] * B


def test_departure_d_cache_index_is_a_host_int():
    _, tcfg, _, tp = _params("llama3_2_3b")
    toks = _tokens(10)
    with torch.no_grad():
        _, cache = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :8])}, decode_budget=2)
        assert type(cache["idx"]) is int and cache["idx"] == 8
        for t in (8, 9):
            _, cache = TD.decode_step(tcfg, tp, cache, torch.as_tensor(
                toks[:, t:t + 1]))
            assert type(cache["idx"]) is int and cache["idx"] == t + 1


def test_serving_steps():
    _, tcfg, _, tp = _params("qwen2_5_3b")
    toks = torch.as_tensor(_tokens(10))
    for leaf in (tp["embed"], tp["unembed"]):
        leaf.requires_grad_(True)      # serving builds no graph regardless
    prefill = TS.make_prefill_step(tcfg, decode_budget=2)
    serve = TS.make_serve_step(tcfg)
    logits, cache = prefill(tp, {"tokens": toks[:, :8]})
    assert not logits.requires_grad and cache["k"].shape[2] == 10
    with torch.no_grad():
        want, want_cache = TD.prefill(tcfg, tp, {"tokens": toks[:, :8]},
                                      decode_budget=2)
    assert torch.equal(logits, want)
    lg, cache = serve(tp, cache, toks[:, 8:9])
    with torch.no_grad():
        want_lg, _ = TD.decode_step(tcfg, tp, want_cache, toks[:, 8:9])
    assert not lg.requires_grad and torch.equal(lg, want_lg)
    assert cache["idx"] == 9


def test_no_decode_path_for_the_classifier():
    cfg = TB.get_reduced("vit16_cifar")
    with pytest.raises(ValueError, match="no decode path"):
        TD.init_cache(cfg, 1, 8, device="cpu")


def test_serve_example_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gen = mod.main(["llama3_2_3b", "--reduced", "--device", "cpu",
                    "--prompt", "24", "--gen", "8"])
    assert gen.shape == (4, 8)
    assert gen.min() >= 0 and gen.max() < 512
    out = capsys.readouterr().out
    assert "generated=8 tokens" in out and "window=32" in out
    # the same prompts and weights, served again, give the same tokens
    again = mod.main(["llama3_2_3b", "--reduced", "--device", "cpu",
                      "--prompt", "24", "--gen", "8"])
    np.testing.assert_array_equal(gen, again)
