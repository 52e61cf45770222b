"""The per-layer readers on synthetic traces, the trace reduction, and the
model-FLOP count against a counted step."""
import json

import pytest
import torch

from bench_cells import lm_cell, vit_cell
from harness.profile import Profile
from harness.runner import MetricContext
from harness.spans import Spans
from harness.spec import BENCH, load_cell, metric_module
from reference.shapes import vit_client_elems, vit_server_elems
from yardstick import flops

VIT = json.loads((BENCH / "configs" / "vit16-cifar.json").read_text())
MOE = json.loads((BENCH / "configs" / "mixtral-8x7b-l2.json").read_text())
FULL = json.loads((BENCH / "traffic" / "fleet48-full.json").read_text())
HBM = 3.35e12
MS = 1_000_000                                    # ns


def _profile(kernels, spans=(), units=(), start=0, end=100 * MS):
    p = Profile(list(kernels), list(spans), start, end)
    p.units = list(units)
    return p


def _read(spec, name, cell, ctx_kw):
    """Metric ``name`` read in ``cell`` of the BENCHMARK.json ``spec``."""
    entry = next(m for m in json.loads(spec.read_text())["per_layer"]
                 if m["name"] == name)
    c = load_cell(spec, cell)
    ctx = MetricContext(cell, c.config, c.traffic, **ctx_kw)
    return metric_module(c, entry).read(ctx)


def test_vit_elements_by_hand():
    dm, ff = 768, 3072
    layer = 4 * dm + 4 * dm * dm + 2 * dm * ff + ff + dm
    inputs = 48 * dm + dm + 64 * dm
    assert vit_client_elems(VIT, 2, 1.0) == inputs + 2 * layer
    half = 4 * dm + 4 * dm * 384 + 2 * dm * 1536 + 1536 + dm
    assert vit_client_elems(VIT, 3, 0.5) == inputs + 3 * half
    assert vit_server_elems(VIT, 5) == 7 * layer + dm * 10 + 10


UNITS = [{"t0": 0.0, "t1": 2.0, "work": 3072,
          "spans": {"init_round": 0.1, "cohort_step": 1.5, "aggregate": 0.2,
                    "fold_server": 0.1},
          "clients": [(2, 1.0, True), (3, 0.5, False), (3, 0.25, True)]},
         {"t0": 2.0, "t1": 3.0, "work": 3072,
          "spans": {"cohort_step": 0.6, "aggregate": 0.1},
          "clients": [(2, 1.0, True)]}]


def test_host_span_readers(staged):
    kw = dict(units=UNITS, window_s=3.0, profile=None)
    assert _read(staged, "round_host_ms.vit", "vit-ssfl-n48", kw) == \
        pytest.approx(1e3 * ((2.0 - 1.9) + (1.0 - 0.7)) / 2)
    assert _read(staged, "cohort_step_ms.vit", "vit-ssfl-n48", kw) == \
        pytest.approx(1e3 * 2.1 / 2)
    assert _read(staged, "aggregate_ms.vit", "vit-ssfl-n48", kw) == \
        pytest.approx(1e3 * 0.3 / 2)


def test_rooflines_and_idle(staged):
    kernels = [("void fuse_kernel<float>(...)", 0, 2 * MS),
               ("void fuse_kernel<float>(...)", 5 * MS, 1 * MS),
               ("void aggregate_kernel<float>(...)", 10 * MS, 4 * MS),
               ("void tier_sum_kernel(...)", 20 * MS, 3 * MS),
               ("sm80_xmma_gemm_f32f32", 30 * MS, 20 * MS)]
    p = _profile(kernels, units=UNITS[:1])
    kw = dict(units=UNITS, window_s=3.0, profile=p)
    steps = FULL["local_steps"]
    fuse = steps * 3 * 4 * (vit_client_elems(VIT, 2, 1.0)
                            + vit_client_elems(VIT, 3, 0.25)) / HBM
    assert _read(staged, "fuse_roofline", "vit-ssfl-n48", kw) == \
        pytest.approx(100 * fuse / 3e-3)
    agg = 0.0
    for feat in (768, 768, 768 * 768, 768 * 768, 768 * 768, 768 * 768, 768,
                 768, 768 * 3072, 3072, 3072 * 768, 768):
        n, L = 48, 12
        agg += (4 * n * L * feat + 8 * L * feat + 4 * n * L) / HBM
    assert _read(staged, "aggregate_roofline", "vit-ssfl-n48", kw) == \
        pytest.approx(100 * agg / 4e-3)
    # depth 3 holds widths 0.5 and 0.25: one fusion of two tiers
    tier = 4 * 3 * vit_server_elems(VIT, 3) / HBM
    assert _read(staged, "tier_sum_roofline", "vit-ssfl-n48-width", kw) == \
        pytest.approx(100 * tier / 3e-3)
    # busy: 2 + 1 + 4 + 3 + 20 ms of 100
    assert _read(staged, "device_idle.vit", "vit-ssfl-n48", kw) == \
        pytest.approx(70)
    assert _read(staged, "matmul_share.lm", "mixtral-tpgf-train", kw) == \
        pytest.approx(100 * 20 / 30)


def test_readers_find_nothing_without_a_trace(staged):
    kw = dict(units=UNITS, window_s=3.0, profile=None)
    for name, cell in (("fuse_roofline", "vit-ssfl-n48"),
                       ("device_idle.vit", "vit-ssfl-n48"),
                       ("matmul_share.lm", "mixtral-tpgf-train")):
        assert _read(staged, name, cell, kw) is None
    kw["profile"] = _profile([("sm80_xmma_gemm", 0, MS)])
    assert _read(staged, "fuse_roofline", "vit-ssfl-n48", kw) is None


def test_mfu(staged):
    steps, batch = FULL["local_steps"], FULL["batch_size"]
    total = sum(steps * flops.vit_client_step(VIT, d, w, batch, a)
                for u in UNITS for d, w, a in u["clients"])
    kw = dict(units=UNITS, window_s=3.0, profile=None)
    assert _read(staged, "mfu.vit", "vit-ssfl-n48", kw) == \
        pytest.approx(100 * total / (3.0 * 67e12))
    lm_units = [{"work": 4096}] * 5
    kw = dict(units=lm_units, window_s=6.0, profile=None)
    per_token = flops.lm_tpgf_step(MOE, 1)
    assert _read(staged, "mfu.lm", "mixtral-tpgf-train", kw) == \
        pytest.approx(100 * 5 * 4096 * per_token / (6.0 * 989e12))
    # 2 layers, split at 1: client 394 M live weights a token, local head
    # and unembed 131 M each, server layer 394 M
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 8 \
        + 2 * 3 * 4096 * 14336
    head = 4096 * 32000
    assert per_token == 10 * layer + 6 * head + 6 * (layer + head)


def test_idle_gaps_named_by_the_innermost_span():
    kernels = [("a", 0, 10), ("b", 30, 10), ("c", 70, 10)]
    spans = [("round", 0, 100), ("cohort_step", 5, 50)]
    p = _profile(kernels, spans, start=0, end=100)
    assert p.busy_s == pytest.approx(30e-9)
    # a gap is named by the span the host was in when it began
    assert p.gaps() == [("cohort_step", pytest.approx(20e-9)),
                        ("cohort_step", pytest.approx(30e-9)),
                        ("round", pytest.approx(20e-9))]
    b = p.breakdown()
    assert b["idle_gaps"] == [["cohort_step", pytest.approx(50e-9)],
                              ["round", pytest.approx(20e-9)]]
    assert [n for n, _ in b["device_ops"]] == ["a", "b", "c"]


def test_spans_pair_with_their_markers():
    s = Spans("cpu")
    s.marking = True
    with s("profiled", timed=False):
        with s("round", timed=False):
            with s("cohort_step"):
                pass
    assert [k for _, k in s.events] == ["b", "b", "b", "e", "e", "e"]
    on_dev = s.on_device([1, 2, 3, 4, 5, 6])
    assert sorted(on_dev) == [("cohort_step", 3, 4), ("profiled", 1, 6),
                              ("round", 2, 5)]
    assert set(s.totals) == {"cohort_step"}
    with pytest.raises(RuntimeError):
        s.on_device([1, 2])


def _count_vit_step(cfg, c, d, width, batch):
    from repro_torch.core import supernet as SN
    from repro_torch.core import tpgf
    from repro_torch.models.model import init_params
    from repro_torch.roofline.analysis import count_flops
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cp, sp, lp = SN.split_params(cfg, params, d, width)
    wcfg = SN.width_cfg(cfg, width)
    g = torch.Generator().manual_seed(1)
    imgs = torch.randn(batch, c["image_size"], c["image_size"], 3,
                       generator=g)
    lab = torch.randint(0, c["n_classes"], (batch,), generator=g)
    counted, _ = count_flops(tpgf.tpgf_grads_split, cfg, wcfg, cp, sp, lp,
                             {"images": imgs, "label": lab}, d,
                             server_available=True)
    return counted


@pytest.mark.parametrize("d,width", [(2, 1.0), (3, 0.5), (1, 0.25)])
def test_vit_flop_count_matches_a_counted_step(d, width):
    from harness.program import model_config
    c = vit_cell().config
    cfg = model_config(c).replace(use_pallas=False)
    batch = 4
    counted = _count_vit_step(cfg, c, d, width, batch)
    seq = (c["image_size"] // c["patch_size"]) ** 2
    # the prefix's attention runs forward and backward twice, the
    # server's forward and backward once
    attn = flops.attention_flops(c, d, seq, batch, 2, width) \
        + flops.attention_flops(c, c["n_layers"] - d, seq, batch, 1)
    model = flops.vit_client_step(c, d, width, batch, True)
    assert counted == pytest.approx(model + attn, rel=1e-9)


def test_lm_flop_count_matches_a_counted_step():
    from harness.program import model_config
    from repro_torch.core import tpgf
    from repro_torch.models.model import init_params
    from repro_torch.roofline.analysis import count_flops
    c = lm_cell().config
    cfg = model_config(c)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, c["vocab"], (B, S), generator=g)
    counted, _ = count_flops(tpgf.tpgf_grads, cfg, params,
                             {"tokens": tok, "labels": tok}, 1)
    # the program scores every (q, k) pair under the causal mask
    attn = flops.attention_flops(c, 1, S, B, 2) \
        + flops.attention_flops(c, 1, S, B, 1)
    # the dense dispatch runs every expert on every token (E/k times the
    # live expert work) and sums them by two einsums, the model count
    # neither; a multiply-add is 2, a backward pass twice its forward
    # (the client layer runs forward once and backward twice: 5, the
    # server layer 3), the routing weights' einsum has no weight gradient
    E, k, dm, ff = c["n_experts"], c["top_k"], c["d_model"], c["d_ff"]
    T = B * S
    excess = (E - k) * 3 * dm * ff * 2 * T * (5 + 3)
    combine = E * T * dm * 2 * (5 + 3) + T * k * E * 2 * (3 + 2)
    model = flops.lm_tpgf_step(c, T)
    assert counted == pytest.approx(model + attn + excess + combine,
                                    rel=1e-9)
