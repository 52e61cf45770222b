"""The plain reference computed in blocks (``reference/tpgf_blocked.py``)
and its driver (``drivers/lm_train_blocked.py``) at a reduced size on the
CPU: the blocks give the whole-graph reference's step, the program
agrees with them and the fp8 control does not, and the planted faults
turn ``correct`` false."""
import copy
import json

import pytest
import torch

import calibrate
from bench_cells import LM_CUT, MOE_CUT, reduced_config, with_limits
from harness.runner import run_cell
from harness.spec import BENCH, Cell
from reference import lm_tpgf, tpgf_blocked
from reference.shapes import moe_tree
from test_bench_cells import (LM_LIMITS, SEED, _half_batch_lm, _tokens_lm,
                              _unchanged_lm)
from traffic.weights import draw


def blocked_cell() -> Cell:
    t = {**json.loads((BENCH / "traffic" / "lm-4x2048.json").read_text()),
         **LM_CUT}
    c = reduced_config("mixtral-8x7b-l2", MOE_CUT)
    return Cell("lm-blocked-test", 1, c, "lm-4x2048", t, {}, [], [])


@pytest.mark.parametrize("fault", [None, "tokens"])
def test_blocks_give_the_whole_graph_step(fault):
    # a clip threshold low enough that the local gradient is clipped
    c = reduced_config("mixtral-8x7b-l2", {**MOE_CUT, "n_layers": 3,
                                           "tpgf_clip": 1e-3})
    t = json.loads((BENCH / "traffic" / "lm-4x2048.json").read_text())
    w = draw(moe_tree(c), seed=SEED, dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, c["vocab"], (4, 24), generator=gen)
    labels = torch.randint(0, c["vocab"], (4, 24), generator=gen)
    whole = lm_tpgf.Trainer(c, copy.deepcopy(w), t["optimizer"], "fp32",
                            fault)
    blocks = tpgf_blocked.Trainer(tpgf_blocked.MIXTRAL, c, w,
                                  t["optimizer"], "fp32", fault)
    for _ in range(2):
        a, b = whole.step(tokens, labels), blocks.step(tokens, labels)
        for k in ("loss_client", "loss_server", "w_client"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-6), k
        for k, g in a["grads"].items():
            torch.testing.assert_close(b["grads"][k], g, rtol=1e-4,
                                       atol=1e-7 * float(g.abs().max()))
    for k, p in whole.p.items():
        # a bf16 rounding of the update may land one ulp apart
        torch.testing.assert_close(blocks.p[k].float(), p.float(),
                                   rtol=1e-2, atol=1e-6)


def test_half_batch_leaves_out_half_the_microbatches():
    c = reduced_config("mixtral-8x7b-l2", {**MOE_CUT, "microbatches": 4})
    t = json.loads((BENCH / "traffic" / "lm-4x2048.json").read_text())
    w = draw(moe_tree(c), seed=SEED, dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, c["vocab"], (4, 16), generator=gen)
    labels = torch.randint(0, c["vocab"], (4, 16), generator=gen)
    half = tpgf_blocked.Trainer(tpgf_blocked.MIXTRAL, c, copy.deepcopy(w),
                                t["optimizer"], "fp32", "half_batch")
    two = tpgf_blocked.Trainer(tpgf_blocked.MIXTRAL,
                               {**c, "microbatches": 2}, w, t["optimizer"])
    a, b = half.step(tokens, labels), two.step(tokens[:2], labels[:2])
    # two of four microbatches, each keeping its quarter: half the sum
    for k, g in b["grads"].items():
        torch.testing.assert_close(a["grads"][k], g / 2, rtol=1e-5,
                                   atol=1e-9)
    assert float(a["loss_client"]) == pytest.approx(float(b["loss_client"]))


def test_program_agrees_and_control_fails():
    cell = with_limits(blocked_cell(), LM_LIMITS)
    rows = list(calibrate.readings(cell, [SEED], [SEED],
                                   faults=["half_batch"], device="cpu"))
    r = {row["kind"]: row["readings"] for row in rows}
    assert set(r["program"]) == set(LM_LIMITS)
    assert not [k for k, v in r["program"].items() if v > LM_LIMITS[k]], \
        r["program"]
    for kind in ("control_fp8", "fault_half_batch"):
        assert any(v > LM_LIMITS[k] for k, v in r[kind].items()), r[kind]


@pytest.mark.parametrize("plant", [None, _half_batch_lm, _tokens_lm,
                                   _unchanged_lm],
                         ids=["sound", "half-batch", "tokens", "unchanged"])
def test_planted_fault_turns_correct_false(monkeypatch, plant):
    if plant is not None:
        plant(monkeypatch)
    res = run_cell(with_limits(blocked_cell(), LM_LIMITS), SEED, 0.2, False,
                   device="cpu")
    assert res["correct"] is (plant is None), res["checks"]
