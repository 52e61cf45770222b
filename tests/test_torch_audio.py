"""The port's audio family (Whisper-small: an encoder over audio frames, a
decoder over tokens that cross-attends to it) against the JAX package, at
the reduced config (2 + 2 layers, d_model 128, 4 heads of 32, 16 frames,
vocab 512; fp32).

- ``gelu`` and ``mlp_apply`` (gelu and geglu) on the same numpy inputs:
  the bf16 activations bit for bit (the contractions within one bf16
  ulp), fp32 within the ViT tolerance;
- ``prefill`` logits and every cache entry (``k``, ``v``, ``cross_k``,
  ``cross_v``, ``pos``, ``idx``) on the plain, flash-wrapper and
  blockwise routes (the reference's Pallas flash in interpret mode):
  flash runs in each decoder layer and nowhere else;
- decode step by step against the reference's ``decode_step`` and the
  teacher-forced prefill, with ``cross_k``/``cross_v`` left bit for bit;
- two steps of ``make_train_step`` against the jitted JAX step (metrics
  1e-5, params 1e-4) at 1 and 2 microbatches, ``sgd`` and ``adamw``; the
  refusal of ``use_pallas=True``; remat keeps the gradients bit for bit;
- ``full_loss``, ``local_only_grads``, the unigram local head,
  ``split_params`` (the client holds ``frame_proj`` and the first ``d``
  encoder layers, the server ``embed``);
- the full-size parameter count on ``meta`` (303,946,752), the bridge
  both ways, a bf16 checkpoint across the packages;
- the encoder's sinusoid at 1,500 frames against the reference's;
- the launcher's zero ``frames``, the serve and train examples on the CPU.
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

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import load_checkpoint as t_load  # noqa: E402
from repro_torch.checkpoint import save_checkpoint as t_save  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_get  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper_small"
B, S = 2, 24             # decoder tokens; 16 frames go to the encoder
BATCH, SEQ, STEPS = 4, 16, 2
# the encoder's sinusoid at Whisper's 1,500 frames, torch fp32 against
# XLA's, both on the CPU: sin and cos of angles up to 1,499 rad differ by
# at most 3.05e-5 (5.5 % of the values differ at all), and 42 of the
# 1,152,000 values round to another bf16, by at most 2^-8 (the bf16
# spacing just below 1); at the reduced config's 16 frames the largest
# difference is 4.2e-7 and no bf16 differs
SINUSOID_FP32_TOL = 4e-5
SINUSOID_BF16_SHARE = 1e-4
SINUSOID_BF16_TOL = 2.0 ** -8


@pytest.fixture(scope="module")
def weights():
    return nudged_weights(ARCH)


@pytest.fixture(scope="module")
def prompt():
    """B prompts: the config's frames and S decoder tokens, numpy."""
    cfg = TB.get_reduced(ARCH)
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def _bf(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t(a):
    """A bf16 numpy array -> the same bits as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _order(bits):
    bits = bits.astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulps(got, want):
    """Per-element distance in bf16 steps (torch bf16 vs numpy bf16)."""
    g = got.contiguous().view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return np.abs(_order(g) - _order(w))


# ------------------------------------------------------------------ gelu

def test_gelu_matches_jax_nn_gelu_bit_for_bit_in_bf16():
    """262,144 bf16 inputs drawn as 3·N(0, 1): ``layers.gelu`` gives the
    bits of ``jax.nn.gelu`` on every one (``F.gelu(x,
    approximate="tanh")`` misses 43 % of them); in fp32 (the fused
    ``F.gelu``, as the chain would) XLA's ``tanh`` differs in the last ulp
    on 31 % of them, within 1e-6."""
    x = _bf(3 * np.random.default_rng(0).standard_normal(262144))
    want = jax.nn.gelu(jnp.asarray(x))
    assert int(_ulps(TL.gelu(_t(x)), want).max()) == 0
    old = torch.nn.functional.gelu(_t(x), approximate="tanh")
    assert (_ulps(old, want) > 0).mean() > 0.4
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(TL.gelu(torch.tensor(x32)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x32))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gelu_is_one_fused_pass_in_fp32(dtype):
    """In fp32 and fp64 ``layers.gelu`` is ``F.gelu(x, approximate="tanh")``
    bit for bit: the bf16 chain's eight passes buy nothing there, where
    neither form matches XLA's ``tanh`` in the last ulp."""
    x = torch.tensor(3 * np.random.default_rng(1).standard_normal(4096),
                     dtype=dtype)
    assert torch.equal(TL.gelu(x), torch.nn.functional.gelu(
        x, approximate="tanh"))


def _mlp_case(arch, dtype):
    """A reduced config's MLP leaves and input [4, 32, d_model] drawn from
    a seed (weights scaled to keep the activations O(1)), numpy."""
    cfg = TB.get_reduced(arch)
    dm, dff = cfg.d_model, cfg.d_ff
    shapes = ({"w_up": (dm, dff), "b_up": (dff,), "w_down": (dff, dm),
               "b_down": (dm,)} if cfg.mlp == "gelu" else
              {"w_gate": (dm, dff), "w_up": (dm, dff), "w_down": (dff, dm)})
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s) * (3 / np.sqrt(s[0]) if len(s) == 2
                                      else 0.5) for k, s in shapes.items()}
    x = rng.standard_normal((4, 32, dm))
    if dtype == "bfloat16":
        return ({k: _bf(v) for k, v in p.items()}, _bf(x))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["whisper_small", "gemma_2b"])
def test_mlp_apply_matches_reference(arch, dtype):
    """Whisper's gelu MLP and Gemma's GeGLU on the same inputs. bf16: the
    activation (and GeGLU's product with the up projection) on the
    reference's own pre-activations bit for bit; the MLP's output within
    one bf16 ulp on under 0.1 % of its elements, from the contractions
    alone (as the moe family's, a bf16 matmul here may round a few
    elements the other way: 0 to 2 of 16,384, with the thread count).
    fp32: within 1e-5 of the largest output (the ViT tolerance;
    ``tanh`` differs from XLA's in the last ulp)."""
    jcfg = JB.get_reduced(arch).replace(dtype=dtype)
    tcfg = TB.get_reduced(arch).replace(dtype=dtype)
    p, x = _mlp_case(arch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = JL.mlp_apply(jcfg, jp, jnp.asarray(x))
    if dtype == "float32":
        got = TL.mlp_apply(tcfg, {k: torch.tensor(v) for k, v in p.items()},
                           torch.tensor(x)).numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    got = TL.mlp_apply(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    ulps = _ulps(got, want)
    assert int(ulps.max()) <= 1 and (ulps > 0).mean() < 1e-3
    if tcfg.mlp == "gelu":
        g = jnp.asarray(x) @ jp["w_up"] + jp["b_up"]
        jact, tact = jax.nn.gelu(g), TL.gelu(_t(np.asarray(g)))
    else:
        g = jnp.asarray(x) @ jp["w_gate"]
        u = np.asarray(jnp.asarray(x) @ jp["w_up"])
        jact = jax.nn.gelu(g) * jnp.asarray(u)
        tact = TL.gelu(_t(np.asarray(g))) * _t(u)
    assert int(_ulps(tact, jact).max()) == 0


# --------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def reference_prefill(weights, prompt):
    jp = jax.tree.map(jnp.asarray, weights)
    runs = {}
    for route in ("plain", "flash", "blockwise"):
        cfg = JB.get_reduced(ARCH).replace(use_pallas=route == "flash")
        thr = JL.ATTN_BLOCKWISE_THRESHOLD
        if route == "blockwise":
            JL.ATTN_BLOCKWISE_THRESHOLD = cfg.enc_frames
        try:
            logits, cache = JD.prefill(cfg, jp, to_jax_batch(prompt),
                                       decode_budget=4)
        finally:
            JL.ATTN_BLOCKWISE_THRESHOLD = thr
        runs[route] = {k: np.asarray(v) for k, v in cache.items()}
        runs[route]["logits"] = np.asarray(logits)
    return runs


@pytest.mark.parametrize("route", ["plain", "flash", "blockwise"])
def test_prefill_matches_reference(weights, prompt, reference_prefill,
                                   monkeypatch, route):
    """Logits and every cache entry within 2e-5 of the reference's on each
    route; flash runs once in each decoder layer, over the S decoder
    positions (the encoder's attention is not causal and the
    cross-attention takes plain attention). The blockwise route's
    threshold is the frame count, so the encoder and the decoder both
    take it."""
    want = reference_prefill[route]
    cfg = TB.get_reduced(ARCH).replace(use_pallas=route == "flash")
    if route == "blockwise":
        monkeypatch.setattr(TL, "ATTN_BLOCKWISE_THRESHOLD", cfg.enc_frames)
    calls = []
    real = FA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(FA, "flash_attention", spy)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    with torch.no_grad():
        logits, cache = TD.prefill(cfg, params, to_torch_batch(prompt),
                                   decode_budget=4)
    assert logits.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(np_of(logits), want["logits"], **LOGIT_TOL)
    assert sorted(cache) == ["cross_k", "cross_v", "idx", "k", "pos", "v"]
    assert sorted(want) == sorted(list(cache) + ["logits"])
    assert cache["k"].shape == (cfg.n_layers, B, S + 4, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    assert cache["cross_k"].shape == (cfg.n_layers, B, cfg.enc_frames,
                                      cfg.n_kv_heads, cfg.resolved_head_dim)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(np_of(cache[key]), want[key],
                                   **LOGIT_TOL, err_msg=key)
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    assert cache["idx"] == int(want["idx"]) == S
    assert calls == ([(S, S, True)] * cfg.n_layers if route == "flash"
                     else [])


def test_init_cache_holds_the_decoders_self_and_cross_entries():
    cfg = TB.get_reduced(ARCH)
    jc = JD.init_cache(JB.get_reduced(ARCH), B, S)
    tc = TD.init_cache(cfg, B, S, device="cpu")
    assert sorted(tc) == sorted(jc)
    for k, v in jc.items():
        if k != "idx":
            assert tuple(tc[k].shape) == v.shape, k
            assert not tc[k].any() if k != "pos" else bool(
                (tc[k] == -1).all())
    assert tc["idx"] == 0


def test_decode_step_by_step_matches_reference(weights, prompt,
                                               reference_prefill):
    """Prefill the frames and S − 6 tokens, decode 6 teacher-forced: the
    logits and the self-attention cache within 2e-5 of the reference's
    ``decode_step`` and the logits within 2e-5 of the teacher-forced
    prefill's; ``cross_k``/``cross_v`` are never recomputed or written:
    the same tensors, bit for bit, after every step."""
    jcfg, tcfg = JB.get_reduced(ARCH), TB.get_reduced(ARCH)
    n0 = S - 6
    jp = jax.tree.map(jnp.asarray, weights)
    tp = bridge.to_model_params(tcfg, weights, device="cpu")
    pre = {"tokens": prompt["tokens"][:, :n0], "frames": prompt["frames"]}
    _, jc = JD.prefill(jcfg, jp, to_jax_batch(pre), decode_budget=6)
    with torch.no_grad():
        _, tc = TD.prefill(tcfg, tp, to_torch_batch(pre), decode_budget=6)
    assert tc["idx"] == n0
    cross = {k: (tc[k], tc[k].clone()) for k in ("cross_k", "cross_v")}
    jstep = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
    full = reference_prefill["plain"]["logits"]
    for t in range(n0, S):
        tok = prompt["tokens"][:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = TD.decode_step(tcfg, tp, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(np_of(tl), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(np_of(tl)[:, 0], full[:, t], **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(np_of(tc[key]), np.asarray(jc[key]),
                                       **LOGIT_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for key, (ref, before) in cross.items():
            assert tc[key] is ref and torch.equal(tc[key], before), key
    assert tc["idx"] == S == int(jc["idx"])


def test_decode_embeds_the_token_at_its_dec_pos_row(weights, prompt):
    """A step at position idx adds ``dec_pos[idx]``: two caches that
    differ only in ``idx`` give other logits for the same token."""
    cfg = TB.get_reduced(ARCH)
    tp = bridge.to_model_params(cfg, weights, device="cpu")
    with torch.no_grad():
        _, c = TD.prefill(cfg, tp, to_torch_batch(prompt), decode_budget=2)
        tok = torch.as_tensor(prompt["tokens"][:, :1])
        a, _ = TD.decode_step(cfg, tp, {k: (v.clone() if torch.is_tensor(v)
                                            else v) for k, v in c.items()},
                              tok)
        c["idx"] += 1
        b, _ = TD.decode_step(cfg, tp, c, tok)
    assert (a - b).abs().max() > 1e-4


# -------------------------------------------------------------- training

@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(weights, mb, opt):
    batches = lm_batches(TB.get_reduced(ARCH), BATCH, SEQ, STEPS)
    jrec, trec, jp, tp = run_train_both(weights, ARCH, mb, opt, batches)
    assert_metrics_close(jrec, trec)
    assert_params_close(jp, tp)
    assert all(r["aux"] == 0.0 for r in trec)


def test_train_step_refuses_use_pallas():
    """The decoder's self-attention is causal and the flash kernel has no
    backward: audio trains with ``use_pallas=False`` only."""
    cfg = TB.get_reduced(ARCH).replace(use_pallas=True)
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        TSTEPS.make_train_step(cfg)
    TSTEPS.make_train_step(cfg.replace(use_pallas=False))


def test_remat_passes_the_encoder_output_into_each_decoder_layer(weights):
    """Under ``cfg.remat`` each decoder layer's checkpoint takes
    ``enc_out`` as an input: the TPGF gradients, the encoder's among
    them, equal the un-checkpointed graph's bit for bit."""
    b = to_torch_batch(lm_batches(TB.get_reduced(ARCH), BATCH, SEQ, 1)[0])
    outs = []
    for remat in (False, True):
        cfg = TB.get_reduced(ARCH).replace(remat=remat)
        p = bridge.to_model_params(cfg, weights, device="cpu")
        outs.append(TT.tpgf_grads(cfg, p, b, cfg.resolved_split_depth))
    assert torch.equal(outs[0].loss_server, outs[1].loss_server)
    for path, g in tree_flatten_with_path(outs[0].grads):
        assert torch.equal(g, tree_get(outs[1].grads, path)), path
    assert outs[1].grads["enc_layers"]["attn"]["wq"][-1].abs().max() > 0


def test_full_loss_and_local_only_grads_match_reference(weights):
    jcfg, tcfg = JB.get_reduced(ARCH), TB.get_reduced(ARCH)
    b = lm_batches(tcfg, BATCH, SEQ, 1)[0]
    jp = jax.tree.map(jnp.asarray, weights)
    tp = bridge.to_model_params(tcfg, weights, device="cpu")
    assert abs(float(JM.full_loss(jcfg, jp, to_jax_batch(b)))
               - float(TM.full_loss(tcfg, tp, to_torch_batch(b)))) \
        <= METRIC_TOL
    d = tcfg.resolved_split_depth
    jg, jl = JT.local_only_grads(jcfg, jp, to_jax_batch(b), d)
    tg, tl = TT.local_only_grads(tcfg, tp, to_torch_batch(b), d)
    assert abs(float(jl) - float(tl)) <= METRIC_TOL
    assert_params_close(jg, tg, tol=1e-5)
    assert tg["frame_proj"].abs().max() > 0
    assert not tg["embed"].any() and not tg["dec_layers"]["attn"]["wq"].any()


def test_local_head_is_a_unigram_over_the_frames(weights):
    """The client head pools the smashed frames and its one distribution
    a sequence predicts every label position; ``valid`` weights them."""
    cfg = TB.get_reduced(ARCH)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    b = to_torch_batch(lm_batches(cfg, BATCH, SEQ, 1)[0])
    z, _ = TM.prefix_apply(cfg, params, b, cfg.resolved_split_depth)
    assert z.shape == (BATCH, cfg.enc_frames, cfg.d_model)
    logits = TM.local_logits(cfg, params, z)
    assert logits.shape == (BATCH, cfg.padded_vocab)
    torch.testing.assert_close(logits, z.mean(dim=1) @ params["local_head"],
                               rtol=0, atol=0)
    wide = logits[:, None].repeat(1, SEQ, 1)
    assert torch.equal(TM.local_loss(cfg, params, z, b),
                       TL.softmax_xent(wide, b["labels"], vocab=cfg.vocab))
    valid = torch.zeros((BATCH, SEQ))
    valid[:, :3] = 1
    jl = JM.local_loss(JB.get_reduced(ARCH),
                       jax.tree.map(jnp.asarray, weights),
                       jnp.asarray(np_of(z)),
                       {"labels": jnp.asarray(b["labels"].numpy()),
                        "valid": jnp.asarray(valid.numpy())})
    tl = TM.local_loss(cfg, params, z, {**b, "valid": valid})
    assert abs(float(jl) - float(tl)) <= METRIC_TOL


def test_split_params_keeps_the_decoder_and_embed_on_the_server(weights):
    jcfg, tcfg = JB.get_reduced(ARCH), TB.get_reduced(ARCH)
    d = tcfg.resolved_split_depth
    tp = bridge.to_model_params(tcfg, weights, device="cpu")
    client, server, local = TSN.split_params(tcfg, tp, d)
    assert sorted(client) == ["enc_layers", "frame_proj"]
    assert sorted(server) == ["dec_layers", "dec_norm", "dec_pos", "embed",
                              "enc_layers", "enc_norm"]
    assert sorted(local) == ["local_head"]
    assert client["enc_layers"]["attn"]["wq"].shape[0] == d
    assert server["enc_layers"]["attn"]["wq"].shape[0] == \
        tcfg.n_enc_layers - d
    assert server["dec_layers"]["attn"]["wq"].shape[0] == tcfg.n_layers
    jviews = JSN.split_params(jcfg, jax.tree.map(jnp.asarray, weights), d)
    for jv, tv in zip(jviews, (client, server, local)):
        assert_params_close(jv, tv, tol=0)
    merged = TSN.merge_params(tcfg, client, server, local)
    for path, x in tree_flatten_with_path(tp):
        assert torch.equal(tree_get(merged, path), x), path


# ------------------------------------------------------ shapes and bridge

def test_full_size_parameter_count_on_meta_matches_reference():
    want = jax.eval_shape(lambda: JM.init_params(JB.get_config(ARCH),
                                                 jax.random.PRNGKey(0)))
    got = TM.init_params(TB.get_config(ARCH), None, device="meta")
    assert {p: (tuple(x.shape), str(x.dtype)[6:])
            for p, x in tree_flatten_with_path(got)} == {
        tuple(getattr(k, "key", k) for k in p): (tuple(x.shape),
                                                 str(x.dtype))
        for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert TM.param_count(got) == 303_946_752
    assert got["dec_pos"].shape == (32768, 768)
    assert got["embed"].shape == (51968, 768) and "unembed" not in got
    assert got["enc_layers"]["attn"]["wq"].shape[0] == 12
    assert "cross" in got["dec_layers"] and "cross" not in got["enc_layers"]


def test_init_distributions_match_reference():
    """Both stacks' ``wo`` and ``w_down`` draw at 0.02/√(2·n_layers) (the
    decoder's count for both, as the reference's), the norms start at
    1 and 0, the other matrices at 0.02."""
    cfg = TB.get_reduced(ARCH).replace(n_layers=2, n_enc_layers=3,
                                       d_model=256, d_ff=512)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    small = 0.02 / np.sqrt(2 * cfg.n_layers)
    for stack in ("enc_layers", "dec_layers"):
        layer = p[stack]
        assert abs(float(layer["attn"]["wo"].std()) - small) < 0.1 * small
        assert abs(float(layer["mlp"]["w_down"].std()) - small) \
            < 0.1 * small
        assert abs(float(layer["attn"]["wq"].std()) - 0.02) < 2e-3
        assert torch.equal(layer["attn_norm_scale"],
                           torch.ones_like(layer["attn_norm_scale"]))
        assert not layer["mlp_norm_bias"].any()
    assert abs(float(p["dec_layers"]["cross"]["wo"].std()) - small) \
        < 0.1 * small
    for name in ("frame_proj", "embed", "dec_pos", "local_head"):
        assert abs(float(p[name].std()) - 0.02) < 2e-3, name


def test_bridge_carries_the_encdec_tree_both_ways(weights):
    cfg = TB.get_reduced(ARCH)
    tp = bridge.to_model_params(cfg, weights, device="cpu")
    back = bridge.to_numpy(tp)
    assert {p for p, _ in tree_flatten_with_path(back)} == {
        tuple(getattr(k, "key", k) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(weights)[0]}
    assert_params_close(weights, tp, tol=0)
    for path, x in tree_flatten_with_path(back):
        np.testing.assert_array_equal(x, tree_get(weights, path))
    bad = dict(weights, unembed=np.zeros((cfg.d_model, cfg.padded_vocab),
                                         np.float32))
    with pytest.raises(ValueError, match="unembed"):
        bridge.to_model_params(cfg, bad, device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_checkpoint_crosses_between_the_packages(weights, tmp_path,
                                                      writer):
    """Reduced Whisper in bf16 (two stacks, ``dec_pos``, no
    ``unembed``) written by one package and read by the other, bit for
    bit, in the reference's raw 2-byte form."""
    cfg = TB.get_reduced(ARCH).replace(dtype="bfloat16")
    tp = bridge.to_model_params(cfg, weights, device="cpu")
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), weights)
    path = str(tmp_path / "ck")
    if writer == "port":
        t_save(path, tp, step=3, meta={"arch": cfg.name})
        tree, manifest = j_load(path)
        got = {tuple(getattr(k, "key", k) for k in p): np.asarray(x)
               for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert sorted(got) == sorted(p for p, _ in tree_flatten_with_path(tp))
        for p, x in tree_flatten_with_path(tp):
            assert manifest["dtypes"]["/".join(p)] == "bfloat16", p
            np.testing.assert_array_equal(got[p].view(np.int16),
                                          x.view(torch.int16).numpy())
    else:
        j_save(path, jp, step=3)
        tree, manifest = t_load(path)
        assert manifest["step"] == 3
        assert "dec_layers/cross/wq" in manifest["keys"]
        for p, x in tree_flatten_with_path(tp):
            y = tree_get(tree, p)
            assert y.dtype == torch.bfloat16 and torch.equal(
                y.view(torch.int16), x.view(torch.int16)), p


@pytest.mark.parametrize("frames", [16, 1500])
def test_sinusoid_matches_reference(frames):
    """The encoder's position signal against the reference's
    ``_sinusoid`` at d_model 768: fp32 within SINUSOID_FP32_TOL (sin and
    cos of angles up to frames − 1 rad: another libm), and the bf16 cast
    off on at most SINUSOID_BF16_SHARE of the values, each by at most
    SINUSOID_BF16_TOL; at 16 frames the bf16 cast is the reference's bit
    for bit."""
    dm = 768
    want = np.asarray(JM._sinusoid(frames, dm, jnp.float32))
    got = TM.sinusoid(frames, dm, torch.float32).numpy()
    assert got.shape == (frames, dm)
    np.testing.assert_allclose(got, want, rtol=0, atol=SINUSOID_FP32_TOL)
    got = TM.sinusoid(frames, dm, torch.bfloat16).float().numpy()
    want = np.asarray(JM._sinusoid(frames, dm, jnp.bfloat16)).astype(
        np.float32)
    diff = np.abs(got - want)
    assert diff.max() <= SINUSOID_BF16_TOL
    assert (diff > 0).mean() <= SINUSOID_BF16_SHARE
    if frames == 16:
        assert diff.max() == 0


def test_embed_inputs_projects_the_frames_and_adds_the_sinusoid(weights,
                                                                prompt):
    cfg = TB.get_reduced(ARCH)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    h, pos = TM.embed_inputs(cfg, params, to_torch_batch(prompt))
    jh, jpos = JM.embed_inputs(JB.get_reduced(ARCH),
                               jax.tree.map(jnp.asarray, weights),
                               to_jax_batch(prompt))
    np.testing.assert_allclose(np_of(h), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert h.shape == (B, cfg.enc_frames, cfg.d_model)


# ---------------------------------------------------- launcher and examples

def test_launcher_batches_carry_zero_frames(capsys):
    cfg = TTRAIN.train_config(ARCH, reduced=True)
    b = next(TTRAIN.device_batches(cfg, SEQ, BATCH, 1, "cpu"))
    assert sorted(b) == ["frames", "labels", "tokens"]
    assert b["frames"].shape == (BATCH, cfg.enc_frames, cfg.d_model)
    assert b["frames"].dtype == torch.float32 and not b["frames"].any()
    full = TB.get_config(ARCH)
    b = next(TTRAIN.device_batches(full.replace(enc_frames=3), 4, 1, 1,
                                   "cpu"))
    assert b["frames"].dtype == torch.bfloat16 and b["frames"].shape == (
        1, 3, full.d_model)
    hist = TTRAIN.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "4", "--seq", "16",
                        "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=whisper-reduced") and "split_depth=1/2" \
        in out[0]
    recs = [json.loads(ln) for ln in out if ln.startswith("{")]
    assert recs == hist and len(recs) == 2
    assert all(np.isfinite(r["loss_server"]) and r["aux"] == 0.0
               for r in recs)


def test_serve_example_draws_the_frames(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = [ARCH, "--reduced", "--device", "cpu", "--prompt", "24",
            "--gen", "6"]
    gen = mod.main(argv)
    assert gen.shape == (4, 6) and gen.min() >= 0 and gen.max() < 512
    out = capsys.readouterr().out
    assert "arch=whisper-reduced" in out and "frames=16" in out
    assert "window=30" in out
    np.testing.assert_array_equal(gen, mod.main(argv))


def test_train_example_accepts_whisper(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "train_lm_supersfl_torch",
        ROOT / "examples" / "train_lm_supersfl_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    monkeypatch.setattr(mod.subprocess, "call",
                        lambda cmd, **kw: seen.update(cmd=cmd) or 0)
    assert mod.main([ARCH, "--device", "cpu"]) == 0
    cmd = seen["cmd"]
    assert cmd[cmd.index("--arch") + 1] == ARCH and "--reduced" in cmd
    # the same arguments, run in this process for two steps
    args = cmd[cmd.index("--arch"):]
    args[args.index("--steps") + 1] = "2"
    args[args.index("--log-every") + 1] = "1"
    args = args[:args.index("--ckpt")]
    hist = TTRAIN.main(args)
    assert len(hist) == 2 and all(np.isfinite(r["loss_client"])
                                  for r in hist)
