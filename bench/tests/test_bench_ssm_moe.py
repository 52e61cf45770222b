"""The ssm_moe cell's driver, reference and readers at a reduced size on
the CPU: the plain reference (``reference.ssm_moe_tpgf``) agrees with the
program and its fp8 control does not; planted faults turn ``correct``
false; the new per-layer readers read a profile's spans."""
import gc
import json

import pytest

import calibrate
from bench_cells import with_limits
from harness.profile import Profile
from harness.runner import MetricContext, run_cell
from harness.spec import BENCH, Cell, load_module
from test_bench_cells import (SEED, _half_batch_lm, _tokens_lm,
                              _unchanged_lm)

CUT = {"n_layers": 4, "layer_kinds": ["mamba", "mamba", "attention",
                                      "mamba"],
       "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
       "d_ff": 32, "vocab": 256, "n_experts": 3, "router_experts": 8,
       "expert_offset": 2, "top_k": 3, "shared_expert_ff": 48,
       "ssm_state": 16, "ssm_head_dim": 16, "remat": False,
       "microbatches": 2}
TRAFFIC = {"batch": 4, "seq_len": 512, "distinct_batches": 4,
           "profile_units": 1}
# each above the program's readings on the CPU and below its control's
LIMITS = {"loss_gap": 5e-5, "loss1_gap": 5e-5, "grad1_gap": 8e-3,
          "grad1_dense_gap": 8e-3, "grad1_ssm_gap": 8e-3,
          "change3_gap": 2e-2}


def ssm_moe_cell() -> Cell:
    c = json.loads((BENCH / "configs" / "granite-4.0-h-small-l10.json")
                   .read_text())
    drv = load_module(BENCH / "drivers" / "lm_train_ssm_moe.py", "drv_sm")
    for k, v in CUT.items():
        c[k] = v
        for src, field in drv.SOURCE_KEYS.items():
            if field == k:
                c[src] = v
    c["reduced"] = sorted(set(c["reduced"]) | set(CUT))
    t = {**json.loads((BENCH / "traffic" / "ssm-moe-4x4096.json")
                      .read_text()), **TRAFFIC}
    return Cell("ssm-moe-test", 1, c, "ssm-moe-4x4096", t, {}, [], [])


def test_reference_agrees_and_control_fails():
    cell = with_limits(ssm_moe_cell(), LIMITS)
    rows = list(calibrate.readings(cell, [SEED], [SEED],
                                   faults=["half_batch"], device="cpu"))
    r = {row["kind"]: row["readings"] for row in rows}
    assert set(r["program"]) == set(LIMITS)
    assert not [k for k, v in r["program"].items() if v > LIMITS[k]], \
        r["program"]
    for kind in ("control_fp8", "fault_half_batch"):
        assert any(v > LIMITS[k] for k, v in r[kind].items()), r[kind]


@pytest.mark.parametrize("plant", [None, _half_batch_lm, _tokens_lm,
                                   _unchanged_lm],
                         ids=["sound", "half-batch", "tokens", "unchanged"])
def test_planted_fault_turns_correct_false(monkeypatch, plant):
    if plant is not None:
        plant(monkeypatch)
    res = run_cell(with_limits(ssm_moe_cell(), LIMITS), SEED, 0.2, False,
                   device="cpu")
    assert res["correct"] is (plant is None), res["checks"]


def test_setup_freezes_the_heap_and_release_unfreezes_it():
    drv = load_module(BENCH / "drivers" / "lm_train_ssm_moe.py", "drv_gc")
    try:
        d = drv.Driver(ssm_moe_cell(), SEED, "cpu", None)
        assert gc.get_freeze_count() > 0
        d.release()
        assert gc.get_freeze_count() == 0
    finally:
        gc.unfreeze()


def test_span_readers():
    spans = [("ssm.mix", 100, 200), ("ssm.scan", 120, 150),
             ("ssm.mix", 300, 400),
             # a backward: the mixer's stretch [500, 600], the scan's
             # [520, 560]; an end point with no begin before it
             ("ssm.mix.backward.begin", 500, 501),
             ("ssm.scan.backward.begin", 520, 521),
             ("ssm.scan.backward.end", 560, 561),
             ("ssm.mix.backward.end", 600, 601),
             ("ssm.scan.backward.end", 700, 701)]
    kernels = [("a", 90, 20), ("b", 110, 50), ("c", 130, 10),
               ("d", 350, 100), ("e", 250, 10), ("f", 510, 5),
               ("g", 530, 40), ("h", 650, 30)]
    prof = Profile(kernels, spans, 0, 1000, units=[{}, {}])
    ctx = MetricContext("c", {}, {}, [], 1e-6, prof)
    read = {n: load_module(BENCH / "metrics" / f"{n}.py", "m_" + n[:8]).read
            for n in ("ssm_mix_ms.ssm_moe", "ssm_scan_ms.ssm_moe")}
    # forward: b [110, 160) and c inside it, d [350, 450): 150 ns;
    # backward: f 5 ns and g 40 ns; over 2 units
    assert read["ssm_mix_ms.ssm_moe"](ctx) == pytest.approx(195e-6 / 2)
    # forward c 10 ns, backward g 40 ns
    assert read["ssm_scan_ms.ssm_moe"](ctx) == pytest.approx(50e-6 / 2)
    ctx.profile = Profile(kernels, [], 0, 1000, units=[{}])
    assert read["ssm_mix_ms.ssm_moe"](ctx) is None


def test_mfu_reads_this_family_alone():
    mfu = load_module(BENCH / "metrics" / "mfu.ssm_moe.py", "m_mfu_sm").read
    c = json.loads((BENCH / "configs" / "granite-4.0-h-small-l10.json")
                   .read_text())
    units = [{"work": 16384}]
    assert 0 < mfu(MetricContext("c", c, {}, units, 1.0, None)) < 100
    mixtral = json.loads((BENCH / "configs" / "mixtral-8x7b-l2.json")
                         .read_text())
    assert mfu(MetricContext("c", mixtral, {}, units, 1.0, None)) is None
