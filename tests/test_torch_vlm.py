"""The port's vlm family (InternVL2-2B: an InternLM2 decoder over a prefix
of projected image patches) against the JAX package, at the reduced
config (2 layers, d_model 128, 16 patches, vocab 512; fp32).

- ``prefill`` logits and caches on the plain, flash-wrapper and blockwise
  routes (the reference's Pallas flash in interpret mode), the patches
  ``patches @ vision_proj`` before the tokens, the cache's ``idx``
  ``n_patches + S``; decode step by step (tokens alone) against the
  reference's ``decode_step`` and the teacher-forced prefill;
- two steps of ``make_train_step`` against the jitted JAX step (metrics
  1e-5, params 1e-4) at 1 and 2 microbatches, ``sgd`` and ``adamw``; the
  losses skip the patch positions; ``full_loss`` and
  ``local_only_grads``;
- ``split_params`` puts ``vision_proj`` on the client; the full-size
  parameter count on ``meta`` against the reference's ``eval_shape``;
- the launcher's zero ``patches``, and the serve example on the CPU.
"""
import importlib.util
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

from repro.configs import base as JB  # noqa: E402
from repro.core import supernet as JSN  # noqa: E402
from repro.core import tpgf as JT  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import supernet as TSN  # noqa: E402
from repro_torch.core import tpgf as TT  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "internvl2_2b"
B, S = 2, 48             # text tokens; 16 patches come first
BATCH, SEQ, STEPS = 4, 16, 2


@pytest.fixture(scope="module")
def weights():
    return nudged_weights(ARCH)


@pytest.fixture(scope="module")
def prompt():
    """A batch of B prompts: S tokens and the config's patches, numpy."""
    cfg = TB.get_reduced(ARCH)
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "patches": rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference_prefill(weights, prompt):
    jp = jax.tree.map(jnp.asarray, weights)
    runs = {}
    n = TB.get_reduced(ARCH).n_patches + S
    for route in ("plain", "flash", "blockwise"):
        cfg = JB.get_reduced(ARCH).replace(use_pallas=route == "flash")
        thr = JL.ATTN_BLOCKWISE_THRESHOLD
        if route == "blockwise":
            JL.ATTN_BLOCKWISE_THRESHOLD = n
        try:
            logits, cache = JD.prefill(cfg, jp, to_jax_batch(prompt))
        finally:
            JL.ATTN_BLOCKWISE_THRESHOLD = thr
        runs[route] = {k: np.asarray(v) for k, v in cache.items()}
        runs[route]["logits"] = np.asarray(logits)
    return runs


@pytest.mark.parametrize("route", ["plain", "flash", "blockwise"])
def test_prefill_matches_reference(weights, prompt, reference_prefill,
                                   monkeypatch, route):
    want = reference_prefill[route]
    cfg = TB.get_reduced(ARCH).replace(use_pallas=route == "flash")
    n = cfg.n_patches + S
    if route == "blockwise":
        monkeypatch.setattr(TL, "ATTN_BLOCKWISE_THRESHOLD", n)
    calls = []
    real = FA.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(FA, "flash_attention", spy)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    with torch.no_grad():
        logits, cache = TD.prefill(cfg, params, to_torch_batch(prompt))
    assert logits.shape == (B, n, cfg.padded_vocab)
    np.testing.assert_allclose(np_of(logits), want["logits"], **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np_of(cache[key]), want[key], **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    assert cache["idx"] == int(want["idx"]) == n
    assert calls == ([n] * cfg.n_layers if route == "flash" else [])


def test_patches_come_first_and_change_the_text_logits(weights, prompt):
    """The patch prefix is ``patches @ vision_proj``; other patches give
    other logits at the text positions."""
    cfg = TB.get_reduced(ARCH)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    batch = to_torch_batch(prompt)
    h, pos = TM.embed_inputs(cfg, params, batch)
    np.testing.assert_allclose(
        np_of(h[:, :cfg.n_patches]),
        prompt["patches"] @ weights["vision_proj"], rtol=1e-5, atol=1e-5)
    assert h.shape[1] == cfg.n_patches + S and pos[0, -1] == h.shape[1] - 1
    # decode and text-only callers embed the tokens alone
    h_tok, _ = TM.embed_inputs(cfg, params, {"tokens": batch["tokens"]})
    torch.testing.assert_close(h_tok, h[:, cfg.n_patches:], rtol=0, atol=0)
    with torch.no_grad():
        a, _ = TD.prefill(cfg, params, batch)
        b, _ = TD.prefill(cfg, params, {**batch,
                                        "patches": batch["patches"] * 0})
    assert (a[:, cfg.n_patches:] - b[:, cfg.n_patches:]).abs().max() > 1e-3


def test_decode_step_by_step_matches_reference(weights, prompt,
                                               reference_prefill):
    """Prefill the patches and S − 6 tokens, decode 6 teacher-forced
    (tokens alone, positions from n_patches + S − 6 on): logits and cache
    within 2e-5 of the reference's ``decode_step``, and within 2e-3 of
    the teacher-forced prefill."""
    jcfg, tcfg = JB.get_reduced(ARCH), TB.get_reduced(ARCH)
    npch, n0 = tcfg.n_patches, S - 6
    jp = jax.tree.map(jnp.asarray, weights)
    tp = bridge.to_model_params(tcfg, weights, device="cpu")
    pre = {"tokens": prompt["tokens"][:, :n0], "patches": prompt["patches"]}
    _, jc = JD.prefill(jcfg, jp, to_jax_batch(pre), decode_budget=6)
    with torch.no_grad():
        _, tc = TD.prefill(tcfg, tp, to_torch_batch(pre), decode_budget=6)
    assert tc["idx"] == npch + n0
    jstep = jax.jit(lambda p, c, t: JD.decode_step(jcfg, p, c, t))
    full = reference_prefill["plain"]["logits"]
    denom = np.abs(full).max()
    for t in range(n0, S):
        tok = prompt["tokens"][:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = TD.decode_step(tcfg, tp, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(np_of(tl), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(np_of(tc["k"]), np.asarray(jc["k"]),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        assert np.abs(np_of(tl)[:, 0] - full[:, npch + t]).max() \
            / denom < 2e-3


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(weights, mb, opt):
    batches = lm_batches(TB.get_reduced(ARCH), BATCH, SEQ, STEPS)
    jrec, trec, jp, tp = run_train_both(weights, ARCH, mb, opt, batches)
    assert_metrics_close(jrec, trec)
    assert_params_close(jp, tp)


def test_losses_skip_the_patch_positions(weights):
    """``local_loss`` and the server's cross-entropy read logits from
    position n_patches on: labels [B, S_text] against logits
    [B, n_patches + S_text, V]."""
    cfg = TB.get_reduced(ARCH)
    params = bridge.to_model_params(cfg, weights, device="cpu")
    b = to_torch_batch(lm_batches(cfg, BATCH, SEQ, 1)[0])
    z, _ = TM.prefix_apply(cfg, params, b, cfg.resolved_split_depth)
    logits = TM.local_logits(cfg, params, z)
    assert logits.shape[1] == cfg.n_patches + SEQ
    want = TL.softmax_xent(logits[:, cfg.n_patches:], b["labels"],
                           vocab=cfg.vocab)
    assert torch.equal(TM.local_loss(cfg, params, z, b), want)


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
    assert tg["vision_proj"].abs().max() > 0


def test_split_params_puts_vision_proj_on_the_client(weights):
    jcfg, tcfg = JB.get_reduced(ARCH), TB.get_reduced(ARCH)
    d = tcfg.resolved_split_depth
    tviews = TSN.split_params(tcfg, bridge.to_model_params(
        tcfg, weights, device="cpu"), d)
    assert sorted(tviews[0]) == ["embed", "layers", "vision_proj"]
    assert sorted(tviews[1]) == ["final_norm", "layers", "unembed"]
    jviews = JSN.split_params(jcfg, jax.tree.map(jnp.asarray, weights), d)
    for jv, tv in zip(jviews, tviews):
        assert_params_close(jv, tv, tol=0)


def test_full_size_parameter_count_on_meta_matches_reference():
    want = jax.eval_shape(lambda: JM.init_params(JB.get_config(ARCH),
                                                 jax.random.PRNGKey(0)))
    got = TM.init_params(TB.get_config(ARCH), None, device="meta")
    assert {p: tuple(x.shape) for p, x in tree_flatten_with_path(got)} == {
        tuple(getattr(k, "key", k) for k in p): tuple(x.shape)
        for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert TM.param_count(got) == 2_083_620_864


def test_launcher_batches_carry_zero_patches():
    cfg = TTRAIN.train_config(ARCH, reduced=True)
    b = next(TTRAIN.device_batches(cfg, SEQ, BATCH, 1, "cpu"))
    assert sorted(b) == ["labels", "patches", "tokens"]
    assert b["patches"].shape == (BATCH, cfg.n_patches, cfg.d_model)
    assert b["patches"].dtype == torch.float32 and not b["patches"].any()
    full = TB.get_config(ARCH)
    b = next(TTRAIN.device_batches(full.replace(n_patches=2), 4, 1, 1,
                                   "cpu"))
    assert b["patches"].dtype == torch.bfloat16
    # an audio batch carries zero frames in place of the patches
    b = next(TTRAIN.device_batches(TB.get_config("whisper_small").replace(
        enc_frames=3), 4, 1, 1, "cpu"))
    assert sorted(b) == ["frames", "labels", "tokens"]
    assert b["frames"].shape == (1, 3, 768) and not b["frames"].any()
    hist = TTRAIN.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "4", "--seq", "16",
                        "--log-every", "1"])
    assert len(hist) == 2 and all(r["aux"] == 0.0 for r in hist)


def test_serve_example_adds_the_patches(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = [ARCH, "--reduced", "--device", "cpu", "--prompt", "24",
            "--gen", "6"]
    gen = mod.main(argv)
    assert gen.shape == (4, 6) and gen.min() >= 0 and gen.max() < 512
    out = capsys.readouterr().out
    # 16 patches + 24 tokens + 6 of room
    assert "patches=16" in out and "window=46" in out
    np.testing.assert_array_equal(gen, mod.main(argv))


def test_the_audio_family_is_still_refused():
    """No longer refused: the audio family builds on ``meta`` with the
    reference's shapes (two stacks, ``dec_pos``, no ``unembed``, no
    ``vision_proj``); ``tests/test_torch_audio.py`` holds it to the
    reference."""
    jcfg, tcfg = JB.get_reduced("whisper_small"), TB.get_reduced(
        "whisper_small")
    want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = TM.init_params(tcfg, None, device="meta")
    assert {p: tuple(x.shape) for p, x in tree_flatten_with_path(got)} == {
        tuple(getattr(k, "key", k) for k in p): tuple(x.shape)
        for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert "vision_proj" not in got and "unembed" not in got
