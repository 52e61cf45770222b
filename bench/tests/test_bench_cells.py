"""A cell added as files and entries alone runs by its name; the plain
references agree with the program at reduced sizes and their
lower-precision controls do not; planted faults turn ``correct`` false."""
import json
import shutil

import pytest
import torch

import calibrate
from bench_cells import (FLEET_CUT, LM_CUT, MOE_CUT, VIT_CELLS, VIT_CUT,
                         VIT_RATE, lm_cell, reduced_config, staged_spec,
                         vit_cell, with_limits)
from harness.runner import run_cell
from harness.spec import BENCH, ROOT, load_cell

# limits at the reduced sizes (the cells' own, at full size, are in
# bench/workloads/): each above the program's readings on the CPU and
# below its control's, with room on both sides
VIT_LIMITS = {"depths_differ": 0, "loss_gap": 1e-6, "client_loss_gap": 5e-7,
              "change1_gap": 5e-3, "change3_gap": 5e-3, "comm_mb_gap": 0}
LM_LIMITS = {"loss_gap": 7e-5, "loss1_gap": 7e-5, "grad1_gap": 8e-3,
             "grad1_dense_gap": 8e-3, "change3_gap": 2e-2}
SEED = 2 ** 31 + 5                   # a seed past 32 signed bits


def _add_cell(tmp_path, kind):
    """A copy of bench/ plus one new cell: a configuration file, a traffic
    file and BENCHMARK.json entries, nothing else."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if kind == "vit":
        # with the ViT rate and its readers' entries, as a later PR adds
        spec = staged_spec()
        cfg, cut = "vit16-cifar", VIT_CUT
        traffic = {**json.loads((BENCH / "traffic" / "fleet48-ladder.json")
                                .read_text()), **FLEET_CUT}
        rate = VIT_RATE
    else:
        cfg, cut = "mixtral-8x7b-l2", MOE_CUT
        traffic = {**json.loads((BENCH / "traffic" / "lm-8x512.json")
                                .read_text()), **LM_CUT}
        rate = "train_tokens_per_s"
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        reduced_config(cfg, cut)))
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    spec["configs"].append({"name": "tiny", "source": "https://example.org",
                            "file": "bench/configs/tiny.json",
                            "reduced": sorted(cut), "why": "test"})
    spec["workloads"] = [{"name": "tiny-cell", "config": "tiny",
                          "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if rate in (m["name"], m.get("moves")):
            m["workloads"] = ["tiny-cell"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return load_cell(tmp_path / "BENCHMARK.json", "tiny-cell", bench=bench)


@pytest.mark.parametrize("kind", ["vit", "lm"])
def test_added_cell_runs_by_name(tmp_path, kind):
    cell = _add_cell(tmp_path, kind)
    res = run_cell(cell, SEED, 0.2, False, device="cpu")
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) and res["correct"] is False   # no limits yet
    traced = run_cell(cell, SEED, 0.2, True, device="cpu")
    # without a device trace only the readers of host time find anything
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert traced["device"]["window_s"] > 0


def _readings(cell, kinds):
    rows = list(calibrate.readings(cell, [SEED], [SEED], device="cpu"))
    return {r["kind"]: r["readings"] for r in rows if r["kind"] in kinds}


@pytest.mark.parametrize("make,limits,control", [
    (lambda: vit_cell("fleet48-full"), VIT_LIMITS, "control_tf32"),
    (lambda: vit_cell("fleet48-ladder"), VIT_LIMITS, "control_tf32"),
    (lambda: lm_cell(), LM_LIMITS, "control_fp8")],
    ids=["vit", "vit-ladder", "mixtral"])
def test_reference_agrees_and_control_fails(make, limits, control):
    cell = with_limits(make(), limits)
    r = _readings(cell, ("program", control))
    assert set(r["program"]) == set(limits)
    failing = [k for k, v in r["program"].items() if v > limits[k]]
    assert not failing, r["program"]
    assert any(v > limits[k] for k, v in r[control].items()), r[control]


def test_every_compared_number_has_a_limit(staged):
    for cell_name in (*VIT_CELLS, "mixtral-tpgf-train"):
        full = load_cell(staged, cell_name)
        names = set(VIT_LIMITS if "vit" in cell_name else LM_LIMITS)
        assert names == set(full.limits), cell_name
        for k, v in full.limits.items():
            assert v["limit"] is not None and v["limit"] >= v["lower"]
            if v["upper"] is not None:
                assert v["limit"] < v["upper"]


# ------------------------------------------------------------ faults

def _half_batch_vit(monkeypatch):
    from repro_torch.core import tpgf
    inner = tpgf.tpgf_grads_split

    def half(cfg, wcfg, c, s, l, batch, d, **kw):
        n = batch["label"].shape[0] // 2
        return inner(cfg, wcfg, c, s, l, {k: v[:n] for k, v in
                                          batch.items()}, d, **kw)
    monkeypatch.setattr(tpgf, "tpgf_grads_split", half)


def _label_vit(monkeypatch):
    from repro_torch.core import tpgf
    inner = tpgf.tpgf_grads_split

    def altered(cfg, wcfg, c, s, l, batch, d, **kw):
        lab = batch["label"].clone()
        lab[0] = (lab[0] + 1) % cfg.n_classes
        return inner(cfg, wcfg, c, s, l, {**batch, "label": lab}, d, **kw)
    monkeypatch.setattr(tpgf, "tpgf_grads_split", altered)


def _unchanged_vit(monkeypatch):
    from repro_torch.federated.strategies import ssfl
    monkeypatch.setattr(ssfl, "apply_updates", lambda p, u: p)


def _half_batch_lm(monkeypatch):
    from repro_torch.core import tpgf
    inner = tpgf.tpgf_grads

    def half(cfg, params, batch, d, **kw):
        n = max(batch["tokens"].shape[0] // 2, 1)
        return inner(cfg, params, {k: v[:n] for k, v in batch.items()}, d,
                     **kw)
    monkeypatch.setattr(tpgf, "tpgf_grads", half)


def _tokens_lm(monkeypatch):
    from repro_torch.core import tpgf
    inner = tpgf.tpgf_grads

    def altered(cfg, params, batch, d, **kw):
        tok = batch["tokens"].clone()
        tok[0] = (tok[0] + 1) % cfg.vocab
        return inner(cfg, params, {**batch, "tokens": tok}, d, **kw)
    monkeypatch.setattr(tpgf, "tpgf_grads", altered)


def _unchanged_lm(monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "apply_in_place",
                        lambda opt, g, state, params: (params, state))


@pytest.mark.parametrize("make,limits,plant", [
    (vit_cell, VIT_LIMITS, None),
    (vit_cell, VIT_LIMITS, _half_batch_vit),
    (vit_cell, VIT_LIMITS, _label_vit),
    (vit_cell, VIT_LIMITS, _unchanged_vit),
    (lm_cell, LM_LIMITS, None),
    (lm_cell, LM_LIMITS, _half_batch_lm),
    (lm_cell, LM_LIMITS, _tokens_lm),
    (lm_cell, LM_LIMITS, _unchanged_lm)],
    ids=["vit-sound", "vit-half-batch", "vit-label", "vit-unchanged",
         "lm-sound", "lm-half-batch", "lm-tokens", "lm-unchanged"])
def test_planted_fault_turns_correct_false(monkeypatch, make, limits, plant):
    if plant is not None:
        plant(monkeypatch)
    res = run_cell(with_limits(make(), limits), SEED, 0.2, False,
                   device="cpu")
    assert res["correct"] is (plant is None), res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("make,limits", [(vit_cell, VIT_LIMITS),
                                         (lm_cell, LM_LIMITS)],
                         ids=["vit", "mixtral"])
def test_reduced_cells_on_the_card(make, limits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_cell(with_limits(make(), limits), SEED, 1.0, True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
