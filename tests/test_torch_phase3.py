"""TPGF's Phase 3 (the clip, then Eq. 4) in the port, on the CPU.

On the card ``core.tpgf.clip_and_fuse`` runs the ``sumsq`` and ``fuse``
kernels, which round once, on the fused value; the plain chain rounds the
clipped local gradient to its dtype before Eq. 4. Here, on one TPGF
microbatch's real client gradients of the reduced moe (Mixtral) and
ssm_moe (Granite) configs in bf16:

- the kernel route, run on CPU tensors through the wrappers' plain
  versions (``fuse_tree(tau=)``), is the fp32 Eq. 4 rounded once, and
  within the plain chain's extra rounding of it in every element (one
  ulp of the result where Eq. 4's terms do not cancel;
  ``ref.plain_chain_bound``);
- ``tpgf_grads_split`` on the CPU still takes the plain chain bit for bit
  and launches nothing;
- with the server unreachable the result is ``_fault_degrade``'s bit for
  bit (the clipped local gradient, ``w_client`` 1, zero server
  gradients), and Eq. 4 is not computed.

And for every config at its reduced size, every client gradient leaf that
reaches Phase 3 is contiguous as autograd returns it (``fuse_leaf`` and
``sumsq_leaf`` refuse any other on the card; autograd lays them out the
same way on the CPU).
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs.base import (ARCH_IDS, EXTRA_ARCH_IDS, get_config,
                                      get_reduced)
from repro_torch.core import supernet as SN
from repro_torch.core import tpgf as T
from repro_torch.kernels.tpgf_fusion import ops as O, ref as R
from repro_torch.launch.train import device_batches
from repro_torch.models import model as M
from repro_torch.tree import tree_flatten_with_path, tree_map

ARCHS = ["mixtral_8x7b", "granite_4_0_h_small"]


def _case(arch):
    """(cfg, client, server, local views, batch, depth) of a reduced
    config in bf16, every leaf nudged so that zero-initialised ones carry
    gradient too."""
    cfg = get_reduced(arch).replace(dtype="bfloat16", microbatches=1)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda x: x + 0.02 * torch.randn(
        x.shape, generator=gen, dtype=x.dtype),
        M.init_params(cfg, gen, device="cpu"))
    tok = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    batch = {"tokens": tok[:, :-1].int(), "labels": tok[:, 1:].int()}
    d = cfg.resolved_split_depth
    return (cfg, *SN.split_params(cfg, params, d), batch, d)


def _phase3_inputs(monkeypatch, arch, **kw):
    """Run ``tpgf_grads_split`` on ``arch``'s case with ``clip_and_fuse``
    watched; returns (cfg, its output, the Phase-3 calls' arguments)."""
    cfg, c, s, l, batch, d = _case(arch)
    cfg = cfg.replace(**kw)
    calls, inner = [], T.clip_and_fuse

    def watched(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(T, "clip_and_fuse", watched)
    out = T.tpgf_grads_split(cfg, cfg, c, s, l, batch, d,
                             server_available=True)
    monkeypatch.setattr(T, "clip_and_fuse", inner)
    return cfg, out, calls


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_rounds_once_within_the_plain_chains_rounding(
        monkeypatch, arch):
    """``fuse_tree(tau=)`` on the CPU (the wrappers' plain versions: Σx²
    leaf by leaf, the clip scale, Eq. 4 with the scale inside) against
    ``clip_by_global_l2`` then ``fuse_gradients``, on the same client
    gradients with the clip engaged: the kernel route is the fp32 Eq. 4
    rounded once, bit for bit, so no element lies farther from it than
    the plain chain's; the two lie within one ulp of the result plus
    ``w`` times one ulp of the clipped term (``ref.plain_chain_bound``)."""
    cfg, out, calls = _phase3_inputs(monkeypatch, arch)
    (gl, gs, w, _), _ = calls[0]
    norm = float(T.clip_by_global_l2(gl, cfg.tpgf_clip)[1])
    tau = min(cfg.tpgf_clip, 0.5 * norm)            # the clip engaged
    assert 0.0 < float(w) < 1.0
    got = O.fuse_tree(gl, gs, w.float(), tau=tau)
    clipped, norm = T.clip_by_global_l2(gl, tau)
    cs = torch.clamp(tau / (norm + 1e-12), max=1.0)
    want = T.fuse_gradients(clipped, gs, w)
    n_bf16 = 0
    for (path, x), (_, y), (_, a), (_, b) in zip(
            tree_flatten_with_path(got), tree_flatten_with_path(want),
            tree_flatten_with_path(gl), tree_flatten_with_path(gs)):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        exact = R.eq4_fp32(a, b, w, cs)
        assert torch.equal(x, exact.to(x.dtype)), path
        assert bool(((x.float() - exact).abs()
                     <= (y.float() - exact).abs()).all()), path
        assert bool(((x.float() - y.float()).abs()
                     <= R.plain_chain_bound(x, y, a, w, cs)).all()), path
        n_bf16 += x.dtype == torch.bfloat16
    assert n_bf16 > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_tpgf_grads_split_on_the_cpu_takes_the_plain_chain(monkeypatch, arch,
                                                           use_pallas):
    """CPU gradients take ``clip_by_global_l2`` then ``fuse_gradients``
    (``use_pallas`` sends Eq. 4 through ``fuse_tree`` without ``tau``):
    the fused gradient is theirs bit for bit, ``fuse_tree`` is never asked
    to clip, and no kernel launches."""
    seen, inner_tree = [], O.fuse_tree

    def watched_tree(*args, **kwargs):
        seen.append(kwargs.get("tau"))
        return inner_tree(*args, **kwargs)

    monkeypatch.setattr(O, "fuse_tree", watched_tree)
    launches = (O.sumsq_leaf.launches, O.fuse_leaf.launches)
    cfg, out, calls = _phase3_inputs(monkeypatch, arch, use_pallas=use_pallas)
    assert (O.sumsq_leaf.launches, O.fuse_leaf.launches) == launches
    assert seen == ([None] if use_pallas else [])
    (gl, gs, w, tau), kw = calls[0]
    assert tau == cfg.tpgf_clip and kw == {"use_pallas": use_pallas}
    want = T.fuse_gradients(T.clip_by_global_l2(gl, tau)[0], gs, w)
    for (path, x), (_, y) in zip(tree_flatten_with_path(out.g_client),
                                 tree_flatten_with_path(want)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("arch", ARCHS)
def test_unreachable_server_is_the_fault_degrade_bit_for_bit(monkeypatch,
                                                             arch):
    """``server_available=False``: Eq. 4 is skipped (``clip_and_fuse`` is
    not called) and the step returns the clipped local gradient, a
    ``w_client`` of exactly 1 and zero server gradients of the server
    tree's shapes and dtypes; losses and the local head's gradient are
    the reachable step's."""
    cfg, live, calls = _phase3_inputs(monkeypatch, arch)
    (gl, _, _, _), _ = calls[0]
    cfg, c, s, l, batch, d = _case(arch)

    def refused(*args, **kwargs):
        raise AssertionError("Eq. 4 computed for an unreachable server")

    monkeypatch.setattr(T, "clip_and_fuse", refused)
    out = T.tpgf_grads_split(cfg, cfg, c, s, l, batch, d,
                             server_available=False)
    clipped, _ = T.clip_by_global_l2(gl, cfg.tpgf_clip)
    for (path, x), (_, y) in zip(tree_flatten_with_path(out.g_client),
                                 tree_flatten_with_path(clipped)):
        assert torch.equal(x, y), path
    assert out.w_client.dtype == live.w_client.dtype
    assert float(out.w_client) == 1.0
    for (path, x), (_, y) in zip(tree_flatten_with_path(out.g_server),
                                 tree_flatten_with_path(live.g_server)):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        assert not x.any(), path
    for name in ("loss_client", "loss_server"):
        assert torch.equal(getattr(out, name), getattr(live, name))
    for (path, x), (_, y) in zip(tree_flatten_with_path(out.g_local),
                                 tree_flatten_with_path(live.g_local)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("arch", ARCH_IDS + ["granite_4_0_h_small"]
                         + EXTRA_ARCH_IDS)
def test_client_gradients_reach_phase3_contiguous(monkeypatch, arch):
    """Every leaf of both client gradients that ``tpgf_grads_split`` hands
    Phase 3 (``clip_and_fuse``), for each config at its reduced size in
    the full config's dtype, is contiguous, so the card's ``sumsq`` and
    ``fuse`` take it without a copy."""
    cfg = get_reduced(arch).replace(dtype=get_config(arch).dtype,
                                    microbatches=1)
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, device="cpu")
    if cfg.family == "vit":
        batch = {"images": torch.randn(2, cfg.image_size, cfg.image_size, 3,
                                       generator=gen),
                 "label": torch.zeros(2, dtype=torch.int64)}
    else:
        batch = next(device_batches(cfg, 16, 2, 1, "cpu"))
    d = cfg.resolved_split_depth
    calls, inner = [], T.clip_and_fuse

    def watched(*args, **kwargs):
        calls.append(args)
        return inner(*args, **kwargs)

    monkeypatch.setattr(T, "clip_and_fuse", watched)
    T.tpgf_grads_split(cfg, cfg, *SN.split_params(cfg, params, d), batch, d,
                       server_available=True)
    (gl, gs, _, _), = calls
    leaves = tree_flatten_with_path(gl) + tree_flatten_with_path(gs)
    assert leaves
    for path, x in leaves:
        assert x.is_contiguous(), (path, x.shape, x.stride())
