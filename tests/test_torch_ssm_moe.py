"""The port's ssm_moe family (Granite-4.0-H-Small) against the plain fp32
reference ``tests/_ssm_moe_ref.py``, at the reduced config (4 layers,
Mamba-2 / Mamba-2 / NoPE attention / Mamba-2, d_model 64, 3 of 8 experts
held from the third, a shared expert; split depth 1), fp32, sequences of
512 tokens (two of the scan's 256-row chunks), on seeded random weights:

- the forward: both heads' logits and both losses, through the plain and
  the blockwise attention;
- one TPGF microbatch's fused gradients (Eq. 3-4) of every leaf, and
  ``make_train_step``'s AdamW update over two microbatches;
- ``split_params`` then ``merge_params`` at every depth, bit for bit,
  each kind's mixer stack cut at its own layers;
- the share: a layer's experts dealt out over shares of the router's
  experts, each share's result with the shared expert counted once, add
  up to the uncut reference layer's;
- the mixer's scan with every chunk at once (``ssd_chunks_at_once``)
  against the chunk loop ``ssd_chunked``, values, final state and
  gradients, fp64;
- the spans ``ssm.mix``, ``ssm.scan`` and ``moe.shared`` in every forward
  run, remat's recomputations included, and the mixer's and the scan's
  backward points in every backward pass, in order;
- what is not ported (serving, a mesh, width < 1) refuses, and
  ``launch.train`` trains the family.

Tolerances: the reference runs the scan step by step where the port runs
it chunked, and sums in other orders elsewhere, so fp32 agreement is to
rounding: 1e-4 relative (and 1e-6 absolute on values of order 1e-2).
"""
import dataclasses

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

import _ssm_moe_ref as R
from repro_torch import trace
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core import supernet as SN
from repro_torch.core import tpgf as T
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path, tree_map

S = 512
OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}


def _cfg(**kw):
    return get_reduced("granite_4_0_h_small").replace(**kw)


def _params(cfg, seed=0):
    """The port's init, every leaf nudged by N(0, 0.02²) so that the
    zero-initialised leaves (norms, conv bias) shape the output too."""
    gen = torch.Generator().manual_seed(seed)
    p = M.init_params(cfg, gen, device="cpu")
    return tree_map(lambda x: x + 0.02 * torch.randn(
        x.shape, generator=gen, dtype=x.dtype), p)


def _batch(cfg, rows=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (rows, S + 1), generator=gen)
    return {"tokens": tok[:, :-1].int(), "labels": tok[:, 1:].int()}


def _close(a, b, rtol=1e-4, atol=1e-6):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


def _leaf_close(got, want, name):
    err = float(torch.linalg.vector_norm(got - want))
    ref = float(torch.linalg.vector_norm(want))
    assert err <= 1e-4 * ref + 1e-7, (name, err, ref)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return cfg, dataclasses.asdict(cfg), _params(cfg), _batch(cfg)


@pytest.mark.parametrize("route", ["plain", "blockwise"])
def test_forward_matches_reference(setup, monkeypatch, route):
    cfg, c, p, batch = setup
    if route == "blockwise":
        monkeypatch.setattr(L, "ATTN_BLOCKWISE_THRESHOLD", S)
    d = cfg.resolved_split_depth
    with torch.no_grad():
        z, _ = M.prefix_apply(cfg, p, batch, d)
        local = M.local_logits(cfg, p, z)
        logits, _ = M.suffix_apply(cfg, p, z, batch, d)
        l_c = M.local_loss(cfg, p, z, batch)
        l_s = M.server_loss(cfg, p, z, batch, d)
        z_r, lc_r, ls_r = R.losses(c, p, batch)
        h_r, _ = R.stack(c, p["layers"], z_r, d, cfg.n_layers)
    _close(z, z_r)
    _close(local, R.local_logits(c, p, z_r))
    _close(logits, R.server_logits(c, p, h_r))
    _close(l_c, lc_r, rtol=1e-5, atol=0)
    _close(l_s, ls_r, rtol=1e-5, atol=0)


def test_fused_gradients_and_adamw_match_reference(setup):
    cfg, c, p, batch = setup
    one = {k: v[:1] for k, v in batch.items()}
    out = T.tpgf_grads(cfg, p, one, cfg.resolved_split_depth)
    want, (l_c, l_s, w_c) = R.tpgf_grads(c, p, one)
    _close(out.loss_client, l_c, rtol=1e-5, atol=0)
    _close(out.loss_server, l_s, rtol=1e-5, atol=0)
    _close(out.w_client, w_c, rtol=1e-5, atol=0)
    for path, g in tree_flatten_with_path(out.grads):
        _leaf_close(g, want[path], "/".join(path))
    # the train step: two microbatches, AdamW
    cfg2 = cfg.replace(microbatches=2)
    step, opt = make_train_step(cfg2, adamw(
        OPT["lr"], b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
        weight_decay=OPT["weight_decay"]))
    mine = tree_map(torch.clone, p)
    _, _, m = step(mine, opt.init(mine), batch)
    new, _, _, mets = R.train_step(dict(c, microbatches=2), p, batch, OPT,
                                   R.adamw_init(p))
    for k, v in zip(("loss_client", "loss_server", "w_client"), mets):
        _close(m[k], v, rtol=1e-5, atol=0)
    for path, x in tree_flatten_with_path(mine):
        _close(x, new[path], rtol=0, atol=2e-6)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "published"])
def test_split_then_merge_at_every_depth(full):
    cfg = get_config("granite_4_0_h_small") if full else _cfg()
    p = (M.init_params(cfg, None, device="meta") if full
         else _params(cfg))
    flat = tree_flatten_with_path(p)
    for d in range(cfg.n_layers + 1):
        client, server, local = SN.split_params(cfg, p, d)
        for kind in ("mamba", "attention"):
            below = cfg.layer_kinds[:d].count(kind)
            for x in client["layers"][kind].values():
                assert x.shape[0] == below
            for x in server["layers"][kind].values():
                assert x.shape[0] == cfg.layer_kinds.count(kind) - below
        assert client["layers"]["moe"]["router"].shape[0] == d
        back = tree_flatten_with_path(SN.merge_params(cfg, client, server,
                                                      local))
        assert [q for q, _ in back] == [q for q, _ in flat]
        for (_, a), (_, b) in zip(back, flat):
            assert a.shape == b.shape and a.dtype == b.dtype
            if not full:
                assert torch.equal(a, b)


@pytest.mark.parametrize("held,dispatch", [(2, "dense"), (4, "dense"),
                                           (2, "gather")])
def test_shares_add_up_to_the_uncut_layer(held, dispatch):
    """Every card's experts of a layer, with the shared expert counted
    once, give the uncut reference layer's output; the balance term is
    the same on every card. (The gather dispatch with room for every
    token: none is dropped.)"""
    whole = _cfg(n_experts=8, expert_offset=0, moe_dispatch=dispatch,
                 moe_capacity_factor=8.0)
    c = dataclasses.asdict(whole)
    p = _params(whole)["layers"]["moe"]
    p = tree_map(lambda x: x[0], p)
    x = torch.randn((2, 64, whole.d_model),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, aux_r = R.moe(c, p, x)
        parts, auxes = [], []
        for off in range(0, 8, held):
            cut = whole.replace(n_experts=held, expert_offset=off)
            share = dict(p, **{k: p[k][off:off + held]
                               for k in ("w_gate", "w_up", "w_down")})
            y, aux = MOE.moe_apply(cut, share, x)
            parts.append(y)
            auxes.append(aux)
        shared = MOE.shared_ffn(p["shared"], x.reshape(-1, x.shape[-1]))
        total = sum(parts) - (len(parts) - 1) * shared.reshape(x.shape)
    _close(total, want)
    for aux in auxes:
        _close(aux, aux_r, rtol=1e-5, atol=0)


class _Count:
    def __init__(self):
        self.n, self.stack, self.points = {}, [], []

    def begin(self, name):
        if name == "ssm.scan":
            assert self.stack[-1] == "ssm.mix"
        if ".backward." in name:
            self.points.append(name)
        self.stack.append(name)
        self.n[name] = self.n.get(name, 0) + 1

    def end(self, name):
        assert self.stack.pop() == name


def test_spans_cover_every_forward_run(setup):
    cfg, _, p, batch = setup
    cfg = cfg.replace(remat=True)
    one = {k: v[:1, :256] for k, v in batch.items()}
    rec = _Count()
    trace.install(rec)
    try:
        T.tpgf_grads(cfg, p, one, 1)
    finally:
        trace.install(None)
    # client: layer 0 (Mamba-2), a forward and a recompute in each of
    # the two pulls; server: layers 1-3 (two Mamba-2), a forward and a
    # recompute in its backward
    assert rec.n["ssm.mix"] == rec.n["ssm.scan"] == 3 + 2 * 2
    assert rec.n["moe.shared"] == rec.n["moe.experts"] == 3 + 3 * 2
    assert not rec.stack
    # each backward through a Mamba-2 layer (two on the server, two
    # pulls through the client's) crosses the mixer's and the scan's
    # edges in order, the scan's inside the mixer's
    assert rec.points == 4 * ["ssm.mix.backward.begin",
                              "ssm.scan.backward.begin",
                              "ssm.scan.backward.end",
                              "ssm.mix.backward.end"]


@pytest.mark.parametrize("S,chunk", [(512, 128), (256, 256), (200, 64)])
def test_chunks_at_once_is_the_chunk_loop(S, chunk):
    """The ssm_moe mixer's scan against ``ssd_chunked``, fp64, with decays
    slow enough that every chunk's state reaches the next ones."""
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,
                                                  ssd_chunks_at_once)
    gen = torch.Generator().manual_seed(4)
    f64 = dict(generator=gen, dtype=torch.float64)
    x = torch.randn((2, S, 3, 4), **f64).requires_grad_(True)
    dt = (0.02 * torch.rand((2, S, 3), **f64)).requires_grad_(True)
    A = -0.5 * torch.rand((3,), **f64)
    B = torch.randn((2, S, 5), **f64).requires_grad_(True)
    C = torch.randn((2, S, 5), **f64).requires_grad_(True)
    want, want_h = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    got, got_h = ssd_chunks_at_once(x, dt, A, B, C, chunk=chunk)
    _close(got, want, rtol=1e-12, atol=1e-12)
    _close(got_h, want_h, rtol=1e-12, atol=1e-12)
    g = torch.randn(want.shape, **f64)
    for a, b in zip(torch.autograd.grad(got, [x, dt, B, C], g),
                    torch.autograd.grad(want, [x, dt, B, C], g)):
        _close(a, b, rtol=1e-10, atol=1e-12)


def test_what_is_not_ported_refuses(setup):
    cfg, _, p, batch = setup
    from repro_torch.launch import sharding as SH
    from repro_torch.models import decode as D
    with pytest.raises(NotImplementedError, match="ssm_moe"):
        D.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ssm_moe"):
        D.prefill(cfg, p, batch)
    with pytest.raises(NotImplementedError, match="ssm_moe"):
        SH.param_pspecs(cfg, p, None)
    with pytest.raises(NotImplementedError, match="ssm_moe"):
        SN.split_params(cfg, p, 1, width=0.5)
    with pytest.raises(NotImplementedError, match="use_pallas"):
        make_train_step(cfg.replace(use_pallas=True))


def test_launch_train_runs_the_family(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "granite_4_0_h_small", "--reduced", "--device",
                "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
                "--log-every", "1"])
    out = capsys.readouterr().out
    assert "granite-reduced" in out and '"step": 2' in out
