"""The port's moe family (Mixtral-8x7B, Grok-1-314B) against the JAX
package, at the reduced configs (2 layers, d_model 128, 4 experts, top-2,
vocab 512; fp32 unless named).

- ``models/moe.py::moe_apply``: dense dispatch in one pass, dense dispatch
  at T = 8,192 (the chunked path: two chunks of ``MOE_TOKEN_CHUNK``), and
  gather dispatch at capacity factors 2.0 and 0.5 (tokens overflow and
  drop) within 2e-5; aux and the router softmax within 1e-6, the top-k
  experts equal; ``top_k`` orders ties as ``jax.lax.top_k`` does;
- bf16 on the same numpy inputs: the elementwise ops (the router's fp32
  cast, silu·u, combine and its bf16 cast, the gather weights) bit for
  bit, the contractions within one bf16 ulp;
- ``expert_ffn`` makes no copy of weight or [E, n, d_ff] size, forward
  or backward, for either token shape; the dense gate/up pair's bf16
  input gradient within the error of ``torch.matmul``'s fold;
- ``prefill`` logits and caches on the plain, flash-wrapper and blockwise
  routes (the reference's Pallas flash in interpret mode), Mixtral's
  prompt past its 16-token window, so the cache rolls; decode step by
  step against the reference's ``decode_step`` and the teacher-forced
  prefill, and the reference's rolling-window property (window 16,
  S = 24);
- two steps of ``make_train_step`` against the jitted JAX step (metrics,
  aux included, 1e-5; params 1e-4) for Mixtral with both dispatches and
  Grok-1, at 1 and 2 microbatches, ``sgd`` and ``adamw``;
- ``full_loss`` and ``local_only_grads``; ``slice_width`` at w = 0.5 on
  the [L, E, dm, dff] expert leaves; the full-size parameter counts on
  ``meta`` against the reference's ``eval_shape``; a bf16 checkpoint
  written by either package read by the other; the launcher and the
  serve example on the CPU.

The weights are the reference's ``init_params`` nudged and carried across
with ``bridge.to_model_params`` (``tests/_torch_lm.py``).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from _torch_lm import (LOGIT_TOL, METRIC_TOL, assert_metrics_close,  # noqa: E402,E501
                       assert_params_close, lm_batches, np_of,
                       nudged_weights, run_train_both, to_jax_batch,
                       to_torch_batch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import load_checkpoint as t_load  # noqa: E402
from repro_torch.checkpoint import save_checkpoint as t_save  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_get  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["mixtral_8x7b", "grok_1_314b"]
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 40              # S > Mixtral's reduced window of 16: the cache rolls
BATCH, SEQ, STEPS = 4, 16, 2


@pytest.fixture(scope="module")
def weights():
    """arch -> the reference's nudged weights as numpy (built once)."""
    return {arch: nudged_weights(arch) for arch in ARCHS}


def _moe_params(arch, seed=0):
    """One layer's moe tree as the reference draws it, nudged; numpy."""
    cfg = JB.get_reduced(arch)
    p = JMOE.moe_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed + 11)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape)).astype(np.float32), p)


# -------------------------------------------------------------- moe_apply

MOE_CASES = {"dense": (dict(), (2, 24)),
             "dense_chunked": (dict(), (2, 4096)),
             "gather_cf2": (dict(moe_dispatch="gather"), (2, 24)),
             "gather_cf0.5": (dict(moe_dispatch="gather",
                                   moe_capacity_factor=0.5), (2, 24))}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, case):
    kw, (b, s) = MOE_CASES[case]
    jcfg = JB.get_reduced(arch).replace(**kw)
    tcfg = TB.get_reduced(arch).replace(**kw)
    p = _moe_params(arch)
    x = np.random.default_rng(5).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    want_y, want_aux = JMOE.moe_apply(jcfg, jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    got_y, got_aux = TMOE.moe_apply(tcfg, bridge.to_torch(p, device="cpu"),
                                    torch.as_tensor(x))
    np.testing.assert_allclose(np_of(got_y), np.asarray(want_y), **MOE_TOL)
    assert got_aux.dtype == torch.float32
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    T, E, k = b * s, tcfg.n_experts, tcfg.top_k
    if case == "dense_chunked":      # the reference's scan takes 2 chunks
        assert T % TMOE.MOE_TOKEN_CHUNK == 0 and T > TMOE.MOE_TOKEN_CHUNK
    if case == "gather_cf0.5":       # capacity holds half the picks
        cap = int(0.5 * T * k / E)
        assert E * cap < T * k


@pytest.mark.parametrize("arch", ARCHS)
def test_router_softmax_and_top_k_match_reference(arch):
    cfg = TB.get_reduced(arch)
    p = _moe_params(arch)
    xt = np.random.default_rng(6).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    logits = (jnp.asarray(xt) @ jnp.asarray(p["router"])).astype(jnp.float32)
    jprobs = jax.nn.softmax(logits, axis=-1)
    jv, ji = jax.lax.top_k(jprobs, cfg.top_k)
    jv = jv / jnp.sum(jv, axis=-1, keepdims=True)
    probs, topv, topi = TMOE.route(cfg, bridge.to_torch(p, device="cpu"),
                                   torch.as_tensor(xt))
    np.testing.assert_allclose(np_of(probs), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(np_of(topv), np.asarray(jv), rtol=0,
                               atol=1e-6)


def test_top_k_orders_ties_as_jax_lax_top_k():
    """Most gates are 0 when the gather dispatch ranks tokens for an
    expert: the lower index must come first among them, as in
    ``jax.lax.top_k`` (``torch.topk`` does not promise that order)."""
    x = np.zeros((4, 50), np.float32)
    x[:, 3] = 1.0
    x[1, 7] = 1.0
    x[2, 40] = 0.5
    jv, ji = jax.lax.top_k(jnp.asarray(x), 10)
    tv, ti = TMOE.top_k(torch.as_tensor(x), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------------- bf16

def _bf(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t(a):
    """A bf16 numpy array -> the same bits as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _ulps(got, want):
    """Largest distance in bf16 steps between two bf16 arrays."""
    def order(a):
        bits = np.asarray(a).view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    g = got.view(torch.int16).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got).view(np.int16)
    return int(np.abs(order(g.view(ml_dtypes.bfloat16))
                      - order(want)).max())


def _bits_equal(got, want):
    g = got.contiguous().view(torch.int16 if got.dtype == torch.bfloat16
                              else torch.int32).numpy()
    w = np.asarray(want)
    w = w.view(np.int16 if w.dtype == ml_dtypes.bfloat16 else np.int32)
    return int((g != w).sum())


def test_bf16_elementwise_ops_bit_for_bit():
    """On the same bf16 numpy inputs: the router logits' fp32 cast,
    silu(g)·u, the one-hot ``combine`` and its bf16 cast, and the gather
    dispatch's weights, each the reference's bits."""
    cfg = TB.get_reduced("mixtral_8x7b")
    E, k = cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(8)
    logits = _bf(rng.standard_normal((64, E)))
    assert _bits_equal(_t(logits).float(),
                       jnp.asarray(logits).astype(jnp.float32)) == 0
    g = _bf(rng.standard_normal((E, 64, 96)) * 3)
    u = _bf(rng.standard_normal((E, 64, 96)))
    want = jax.nn.silu(jnp.asarray(g)) * jnp.asarray(u)
    assert _bits_equal(TL.silu(_t(g)) * _t(u), want) == 0
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((64, E)),
                                       jnp.float32), axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    topv = topv / jnp.sum(topv, axis=-1, keepdims=True)
    jcomb = jnp.einsum("tke,tk->te", jax.nn.one_hot(topi, E,
                                                    dtype=jnp.float32), topv)
    tcomb = torch.einsum("tke,tk->te", torch.nn.functional.one_hot(
        torch.tensor(np.asarray(topi)).long(), E).float(),
        torch.tensor(np.asarray(topv)))
    assert _bits_equal(tcomb, jcomb) == 0
    assert _bits_equal(tcomb.to(torch.bfloat16),
                       jcomb.astype(jnp.bfloat16)) == 0
    gval = np.asarray(jax.lax.top_k(jcomb.T, 40)[0])
    jw = jnp.where(jnp.asarray(gval) > 0, jnp.asarray(gval), 0.0).astype(
        jnp.bfloat16)
    tg = torch.tensor(gval)
    tw = torch.where(tg > 0, tg, torch.zeros_like(tg)).to(torch.bfloat16)
    assert _bits_equal(tw, jw) == 0


def test_bf16_contractions_within_one_ulp():
    """The moe contractions in bf16, as the port writes them, on the same
    bf16 inputs: the router, the experts' gate/up/down (dense: every
    expert on every token; gather: per-expert rows) and the combine sum,
    each within one bf16 ulp of XLA's."""
    cfg = TB.get_reduced("mixtral_8x7b")
    E, dm, dff, T = cfg.n_experts, cfg.d_model, cfg.d_ff, 64
    rng = np.random.default_rng(9)
    xt = _bf(rng.standard_normal((T, dm)))
    router = _bf(rng.standard_normal((dm, E)) * 0.1)
    wg = _bf(rng.standard_normal((E, dm, dff)) * 0.1)
    wd = _bf(rng.standard_normal((E, dff, dm)) * 0.1)
    h = _bf(rng.standard_normal((E, T, dff)))
    sel = _bf(rng.standard_normal((E, 24, dm)))
    comb = _bf(rng.random((T, E)))
    j = {k: jnp.asarray(v) for k, v in dict(xt=xt, router=router, wg=wg,
                                            wd=wd, h=h, sel=sel,
                                            comb=comb).items()}
    t = {k: _t(v) for k, v in dict(xt=xt, router=router, wg=wg, wd=wd, h=h,
                                   sel=sel, comb=comb).items()}
    y_e = np.asarray(jnp.einsum("etf,efd->etd", j["h"], j["wd"]))
    pairs = [
        (t["xt"] @ t["router"], j["xt"] @ j["router"]),
        (TMOE.gate_up({"w_gate": t["wg"], "w_up": t["wg"]}, t["xt"])[0],
         jnp.einsum("td,edf->etf", j["xt"], j["wg"])),
        (torch.matmul(t["h"], t["wd"]), y_e),
        (torch.einsum("etd,te->td", _t(y_e), t["comb"]),
         jnp.einsum("etd,te->td", jnp.asarray(y_e), j["comb"])),
        (TMOE.gate_up({"w_gate": t["wg"], "w_up": t["wg"]}, t["sel"])[0],
         jnp.einsum("ecd,edf->ecf", j["sel"], j["wg"])),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.bfloat16
        assert _ulps(got, np.asarray(want)) <= 1, i


def _expert_weights(dtype, device="cpu", seed=12):
    cfg = TB.get_reduced("mixtral_8x7b")
    E, dm, dff = cfg.n_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator().manual_seed(seed)
    return {k: (0.1 * torch.randn(s, generator=g)).to(dtype).to(device)
            for k, s in (("w_gate", (E, dm, dff)), ("w_up", (E, dm, dff)),
                         ("w_down", (E, dff, dm)))}


def _matmul_expert_ffn(p, x):
    """``expert_ffn`` as ``torch.matmul`` on every token shape (the
    broadcast fold for x [n, dm])."""
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(TL.silu(g) * u, p["w_down"])


def _ffn_and_grads(fn, p, x, dy):
    """fn's output and its gradients for x and each weight, given dy."""
    x = x.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in p.items()}
    y = fn(w, x)
    return (y, *torch.autograd.grad(y, [x, *w.values()], dy))


@pytest.mark.parametrize("rows", ["dense", "gather"])
def test_expert_ffn_copies_nothing_of_weight_or_intermediate_size(rows):
    """``expert_ffn`` forward and backward in bf16 on ``meta`` tensors at
    the reduced Mixtral's widths: no ``clone``, ``copy_`` or ``_to_copy``
    outputs E·dm·dff or E·n·dff elements or more (``meta`` takes the
    card's branch of ``_bmm_f32``; on the CPU, bf16 operands are widened
    there). ``torch.matmul`` on x [n, dm] makes such copies (its fold),
    which shows the check sees them. Against ``torch.matmul`` throughout,
    the dense dispatch's tokens x [n, dm] give the same outputs and
    gradients within fp32 rounding, the gather dispatch's x [E, cap, dm]
    the same bits in bf16."""
    from torch.utils._python_dispatch import TorchDispatchMode
    p = _expert_weights(torch.bfloat16, "meta")
    E, dm, dff = p["w_gate"].shape
    n = 24
    shape = (n, dm) if rows == "dense" else (E, n, dm)
    big = min(E * dm * dff, E * n * dff)

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sizes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in (torch.ops.aten.clone,
                                       torch.ops.aten.copy_,
                                       torch.ops.aten._to_copy):
                self.sizes.append(out.numel())
            return out

    def copies(fn):
        x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        with Copies() as mode:
            _ffn_and_grads(fn, p, x, torch.empty((E, n, dm), device="meta",
                                                 dtype=torch.bfloat16))
        return [s for s in mode.sizes if s >= big]

    assert copies(TMOE.expert_ffn) == []
    if rows == "dense":
        assert len(copies(_matmul_expert_ffn)) >= 2

    dtype = torch.float32 if rows == "dense" else torch.bfloat16
    p = _expert_weights(dtype)
    g = torch.Generator().manual_seed(13)
    x = torch.randn(shape, generator=g).to(dtype)
    dy = torch.randn((E, n, dm), generator=g).to(dtype)
    got = _ffn_and_grads(TMOE.expert_ffn, p, x, dy)
    want = _ffn_and_grads(_matmul_expert_ffn, p, x, dy)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, i
        if rows == "dense":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a.contiguous().view(torch.int16),
                               b.contiguous().view(torch.int16)), i


def test_bf16_dense_input_gradient_within_the_folded_paths_error():
    """The dense dispatch's input gradient of the gate/up pair in bf16,
    against the same sums in float64: its error norm within that of the
    folded ``torch.matmul`` (each weight's sum rounded, then their sum)."""
    p = _expert_weights(torch.bfloat16, seed=14)
    E, dm, dff = p["w_gate"].shape
    g = torch.Generator().manual_seed(15)
    x = torch.randn((64, dm), generator=g).bfloat16()
    dg, du = (torch.randn((E, 64, dff), generator=g).bfloat16()
              for _ in range(2))
    want = sum(torch.einsum("etf,edf->td", d.double(), p[k].double())
               for d, k in ((dg, "w_gate"), (du, "w_up")))

    def input_grad(fn):
        xg = x.clone().requires_grad_()
        w = {k: v.clone().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad(fn(w, xg), xg, (dg, du))[0]

    new = input_grad(TMOE.gate_up)
    fold = input_grad(lambda w, xg: (torch.matmul(xg, w["w_gate"]),
                                     torch.matmul(xg, w["w_up"])))
    assert new.dtype == fold.dtype == torch.bfloat16
    err_new = float((new.double() - want).norm())
    err_fold = float((fold.double() - want).norm())
    assert err_new <= err_fold, (err_new, err_fold)


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def reference_prefill(weights):
    """Per arch: tokens and the reference's prefill (logits, k, v, pos,
    idx) on each attention route."""
    out = {}
    toks = np.random.default_rng(4).integers(0, 512, (B, S)).astype(
        np.int32)
    for arch in ARCHS:
        jp = jax.tree.map(jnp.asarray, weights[arch])
        runs = {}
        for route in ("plain", "flash", "blockwise"):
            cfg = JB.get_reduced(arch).replace(use_pallas=route == "flash")
            thr = JL.ATTN_BLOCKWISE_THRESHOLD
            if route == "blockwise":
                JL.ATTN_BLOCKWISE_THRESHOLD = S
            try:
                logits, cache = JD.prefill(cfg, jp,
                                           {"tokens": jnp.asarray(toks)})
            finally:
                JL.ATTN_BLOCKWISE_THRESHOLD = thr
            runs[route] = {k: np.asarray(v) for k, v in cache.items()}
            runs[route]["logits"] = np.asarray(logits)
        out[arch] = runs
    return toks, out


@pytest.mark.parametrize("route", ["plain", "flash", "blockwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(weights, reference_prefill, monkeypatch,
                                   arch, route):
    toks, ref = reference_prefill
    want = ref[arch][route]
    cfg = TB.get_reduced(arch).replace(use_pallas=route == "flash")
    if route == "blockwise":
        monkeypatch.setattr(TL, "ATTN_BLOCKWISE_THRESHOLD", S)
    calls = []
    real = FA.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw["window"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(FA, "flash_attention", spy)
    params = bridge.to_model_params(cfg, weights[arch], device="cpu")
    with torch.no_grad():
        logits, cache = TD.prefill(cfg, params,
                                   {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(np_of(logits), want["logits"], **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np_of(cache[key]), want[key], **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    assert cache["idx"] == int(want["idx"]) == S
    np.testing.assert_allclose(want["logits"], ref[arch]["plain"]["logits"],
                               **LOGIT_TOL)
    W = cfg.sliding_window or S
    assert cache["k"].shape[2] == W
    # every slot holds position p with p % W == slot, the last W of them
    pos = cache["pos"].numpy()
    assert (pos % W == np.arange(W)).all() and pos.min() == S - W
    want_calls = [cfg.sliding_window] * cfg.n_layers if route == "flash" \
        else []
    assert calls == want_calls


def _decode_both(jcfg, tcfg, np_p, toks, n0, budget):
    """Prefill ``toks[:, :n0]`` and decode the rest teacher-forced, in
    both packages; per step (port logits, reference logits)."""
    jp = jax.tree.map(jnp.asarray, np_p)
    tp = bridge.to_model_params(tcfg, np_p, device="cpu")
    _, jc = JD.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :n0])},
                       decode_budget=budget)
    with torch.no_grad():
        _, tc = TD.prefill(tcfg, tp, {"tokens": torch.as_tensor(
            toks[:, :n0])}, decode_budget=budget)
    jstep = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
    out = []
    for t in range(n0, toks.shape[1]):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            tl, tc = TD.decode_step(tcfg, tp, tc, torch.as_tensor(
                toks[:, t:t + 1]))
        out.append((np_of(tl), np.asarray(jl)))
        np.testing.assert_allclose(np_of(tc["k"]), np.asarray(jc["k"]),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
    return out, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_by_step_matches_reference(weights, reference_prefill,
                                               arch):
    """Prefill 32 tokens, decode 8 (Mixtral's 16-slot cache wraps): each
    step's logits and cache within 2e-5 of the reference's ``decode_step``,
    and the logits within 2e-3 of the teacher-forced prefill's (the
    reference's own decode bound)."""
    toks, ref = reference_prefill
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    n0 = S - 8
    steps, _ = _decode_both(jcfg, tcfg, weights[arch], toks, n0, 8)
    full = ref[arch]["plain"]["logits"]
    denom = np.abs(full).max()
    for i, (got, want) in enumerate(steps):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        assert np.abs(got[:, 0] - full[:, n0 + i]).max() / denom < 2e-3


def test_rolling_window_cache_matches_windowed_attention():
    """``tests/test_decode_parity.py``'s property on the port: decode with
    a rolling 16-slot cache (reduced Mixtral, S = 24) equals the windowed
    teacher-forced prefill."""
    cfg = TB.get_reduced("mixtral_8x7b")
    W, S24 = cfg.sliding_window, 24
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, S24)))
    with torch.no_grad():
        full, _ = TD.prefill(cfg, params, {"tokens": toks})
        _, cache = TD.prefill(cfg, params, {"tokens": toks[:, :S24 - 4]})
        assert cache["k"].shape[2] == W
        outs = []
        for t in range(S24 - 4, S24):
            lg, cache = TD.decode_step(cfg, params, cache, toks[:, t:t + 1])
            outs.append(np_of(lg[:, 0]))
    got = np.stack(outs[:-1], 1)
    want = np_of(full[:, S24 - 4:S24 - 1])
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 2e-3


def test_moe_cache_holds_kv_and_decode_embeds_the_token_alone():
    cfg = TB.get_reduced("grok_1_314b")
    c = TD.init_cache(cfg, 2, 12, device="cpu")
    assert sorted(c) == ["idx", "k", "pos", "v"]
    assert c["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                            cfg.resolved_head_dim)


# --------------------------------------------------------------- training

TRAIN_CASES = [(arch, kw, mb, opt)
               for arch, kw in (("mixtral_8x7b", {}),
                                ("mixtral_8x7b", {"moe_dispatch": "gather"}),
                                ("grok_1_314b", {}))
               for mb in (1, 2) for opt in ("adamw", "sgd")]


@pytest.mark.parametrize("arch,kw,mb,opt", TRAIN_CASES, ids=[
    f"{a}-{kw.get('moe_dispatch', 'dense')}-mb{mb}-{o}"
    for a, kw, mb, o in TRAIN_CASES])
def test_train_step_matches_reference(weights, arch, kw, mb, opt):
    batches = lm_batches(TB.get_reduced(arch), BATCH, SEQ, STEPS)
    jrec, trec, jp, tp = run_train_both(weights[arch], arch, mb, opt,
                                        batches, **kw)
    assert_metrics_close(jrec, trec)
    assert_params_close(jp, tp)
    # the prefix's router loss is reported with one microbatch
    assert all((r["aux"] > 0) == (mb == 1) for r in trec)


def test_remat_keeps_the_router_loss_and_gradients(weights):
    """Under ``cfg.remat`` each layer's checkpoint returns (h, aux): the
    TPGF gradients and aux equal the un-checkpointed graph's bit for
    bit."""
    b = to_torch_batch(lm_batches(TB.get_reduced("mixtral_8x7b"), BATCH,
                                  SEQ, 1)[0])
    outs = []
    for remat in (False, True):
        cfg = TB.get_reduced("mixtral_8x7b").replace(remat=remat)
        p = bridge.to_model_params(cfg, weights["mixtral_8x7b"],
                                   device="cpu")
        outs.append(TT.tpgf_grads(cfg, p, b, cfg.resolved_split_depth))
    assert not outs[1].aux.requires_grad
    assert torch.equal(outs[0].aux, outs[1].aux)
    for path, g in tree_flatten_with_path(outs[0].grads):
        assert torch.equal(g, tree_get(outs[1].grads, path)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_full_loss_and_local_only_grads_match_reference(weights, arch):
    jcfg, tcfg = JB.get_reduced(arch), TB.get_reduced(arch)
    b = lm_batches(tcfg, BATCH, SEQ, 1)[0]
    jp = jax.tree.map(jnp.asarray, weights[arch])
    tp = bridge.to_model_params(tcfg, weights[arch], device="cpu")
    want = JM.full_loss(jcfg, jp, to_jax_batch(b))
    got = TM.full_loss(tcfg, tp, to_torch_batch(b))
    assert abs(float(want) - float(got)) <= METRIC_TOL
    d = tcfg.resolved_split_depth
    jg, jl = JT.local_only_grads(jcfg, jp, to_jax_batch(b), d)
    tg, tl = TT.local_only_grads(tcfg, tp, to_torch_batch(b), d)
    assert abs(float(jl) - float(tl)) <= METRIC_TOL
    assert_params_close(jg, tg, tol=1e-5)
    assert not tg["layers"]["moe"]["w_gate"][d:].any()


def test_slice_width_on_the_expert_leaves_matches_reference(weights):
    """w = 0.5 keeps the first d_ff/2 channels of every expert's
    ``w_gate``/``w_up`` (last axis) and ``w_down`` (second to last); the
    router stays whole."""
    jcfg, tcfg = JB.get_reduced("mixtral_8x7b"), TB.get_reduced(
        "mixtral_8x7b")
    np_p = weights["mixtral_8x7b"]
    jv = JSN.slice_width(jcfg, jax.tree.map(jnp.asarray, np_p["layers"]),
                         0.5)
    tv = TSN.slice_width(tcfg, bridge.to_torch(np_p["layers"], device="cpu"),
                         0.5)
    assert tuple(tv["moe"]["w_gate"].shape) == (2, 4, 128, 128)
    assert tuple(tv["moe"]["w_down"].shape) == (2, 4, 128, 128)
    assert tuple(tv["moe"]["router"].shape) == (2, 128, 4)
    assert_params_close(jv, tv, tol=0)
    jc = JSN.split_params(jcfg, jax.tree.map(jnp.asarray, np_p), 1, 0.5)
    tc = TSN.split_params(tcfg, bridge.to_model_params(tcfg, np_p,
                                                       device="cpu"), 1, 0.5)
    for j, t in zip(jc, tc):
        assert_params_close(j, t, tol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_count_on_meta_matches_reference(arch):
    want = jax.eval_shape(lambda: JM.init_params(JB.get_config(arch),
                                                 jax.random.PRNGKey(0)))
    got = TM.init_params(TB.get_config(arch), None, device="meta")
    shapes = {p: tuple(x.shape) for p, x in tree_flatten_with_path(got)}
    assert shapes == {tuple(getattr(k, "key", k) for k in p): tuple(x.shape)
                      for p, x in
                      jax.tree_util.tree_flatten_with_path(want)[0]}
    n = TM.param_count(got)
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    if arch == "mixtral_8x7b":
        assert n == 46_833_864_704
    assert all(x.dtype == torch.bfloat16 for _, x in
               tree_flatten_with_path(got))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_checkpoint_crosses_between_the_packages(weights, tmp_path,
                                                      writer):
    """Reduced Mixtral in bf16 (the expert leaves [L, E, dm, dff] and the
    router) written by one package and read by the other, bit for
    bit."""
    cfg = TB.get_reduced("mixtral_8x7b").replace(dtype="bfloat16")
    tp = bridge.to_model_params(cfg, weights["mixtral_8x7b"], device="cpu")
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                      weights["mixtral_8x7b"])
    path = str(tmp_path / "ck")
    if writer == "port":
        t_save(path, tp, step=3, meta={"arch": cfg.name})
        tree, manifest = j_load(path)
        assert manifest["dtypes"]["layers/moe/w_gate"] == "bfloat16"
        got = {tuple(getattr(k, "key", k) for k in p): np.asarray(x)
               for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for p, x in tree_flatten_with_path(tp):
            # the reference's loader hands back the raw 2-byte words
            assert manifest["dtypes"]["/".join(p)] == "bfloat16", p
            np.testing.assert_array_equal(got[p].view(np.int16),
                                          x.view(torch.int16).numpy())
    else:
        j_save(path, jp, step=3)
        tree, manifest = t_load(path)
        assert manifest["step"] == 3
        for p, x in tree_flatten_with_path(tp):
            y = tree_get(tree, p)
            assert y.dtype == torch.bfloat16 and torch.equal(
                y.view(torch.int16), x.view(torch.int16)), p


# ------------------------------------------------ launcher and example

def test_train_launcher_on_the_cpu(capsys):
    hist = TTRAIN.main(["--arch", "mixtral_8x7b", "--reduced", "--device",
                        "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
                        "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=mixtral-reduced")
    recs = [json.loads(ln) for ln in out if ln.startswith("{")]
    assert recs == hist and len(recs) == 2
    assert all(r["aux"] > 0 for r in recs)


def test_serve_example_defaults_to_mixtral_and_cuts_its_layers(capsys,
                                                               monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gen = mod.main(["--reduced", "--device", "cpu", "--prompt", "24",
                    "--gen", "6"])
    assert gen.shape == (4, 6) and gen.min() >= 0 and gen.max() < 512
    out = capsys.readouterr().out
    assert "arch=mixtral-reduced" in out and "window=16" in out
    np.testing.assert_array_equal(gen, mod.main(
        ["mixtral_8x7b", "--reduced", "--device", "cpu", "--prompt", "24",
         "--gen", "6"]))
    # at full size the default cut is 16 of 32 layers (stopped before
    # the 47 GB of weights are drawn)
    class Drawn(Exception):
        pass

    def init_params(cfg, gen, device):
        raise Drawn(cfg.n_layers)

    monkeypatch.setattr(mod.M, "init_params", init_params)
    for argv, layers in ((["--device", "cpu"], 16),
                         (["--device", "cpu", "--layers", "2"], 2)):
        with pytest.raises(Drawn) as drawn:
            mod.main(argv)
        assert drawn.value.args == (layers,)
        assert f"cut: {layers} of 32 layers" in capsys.readouterr().out
