"""The ``late`` driver at its toy size on the CPU (``late_tiny.py``): a sound
run is ``correct``; the control (the reference in fp8 in the port's place)
is not; and neither is a run with a fault planted under the timed path: a
stale page sweep (the previous round's pages), a router that picks the
experts of the smallest scores, combine weights without the routed scale, and an
answer altered where it is made. The counts of ``yardstick_moe.py`` at the
published widths, and the per-layer readers on a run's records."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from perfbench import yardstick_moe
from perfbench.harness import ROOT, Bench, check, measure, run, verdict
from perfbench.tests.late_tiny import CELL, LIMITS, make_late_root

SEED = 2**31 + 11
FULL = json.loads((ROOT / "perfbench" / "configs" / "colpali-kimi-vl-a3b.json").read_text())


@pytest.fixture
def late_root(tmp_path):
    return make_late_root(tmp_path)


def _run(root, trace=False):
    bench = Bench(root)
    return run(bench, bench.cell(CELL, SEED, "cpu", trace), 0.5, 0.0, device_name="cpu")


def test_sound_run_is_correct_with_room(late_root):
    line = _run(late_root)
    assert line["correct"], line["compared"]
    assert set(line["compared"]) == set(LIMITS)
    for name, row in line["compared"].items():
        assert row["value"] <= row["limit"] / 3, (name, row)


def test_control_is_not_correct(late_root):
    bench = Bench(late_root)
    cell = bench.cell(CELL, SEED, "cpu", False)
    driver = bench.driver(cell)
    session = driver.Session(cell)
    session.warmup()
    records = measure(session, cell, 0.3)[0]
    session.free()
    correct, compared = verdict(check(session, records, cell, driver.CONTROL), cell.limits)
    assert not correct, compared


def _plant(monkeypatch, fault):
    if fault == "stale":
        orig, last = EncodingEngine.encode_images_cached, {}

        def stale(self, cache):
            out = orig(self, cache)
            prev = last.get("out", out)
            last["out"] = out
            return prev

        monkeypatch.setattr(EncodingEngine, "encode_images_cached", stale)
    elif fault == "router":
        orig = tmoe.route

        def lowest(x, w, bias, **kw):
            return orig(x, -w, -bias, **kw)

        monkeypatch.setattr(tmoe, "route", lowest)
    elif fault == "unscaled":
        orig = tmoe.route
        monkeypatch.setattr(tmoe, "route", lambda *a, scale, **kw: orig(*a, scale=1.0, **kw))
    else:
        orig = EncodingEngine._text_batch

        def altered(self, *a):
            out = orig(self, *a).clone()
            out[:, 1] = -out[:, 1]  # every caption's second token
            return out

        monkeypatch.setattr(EncodingEngine, "_text_batch", altered)


@pytest.mark.parametrize("fault", ["stale", "router", "unscaled", "altered"])
def test_planted_fault_is_not_correct(late_root, monkeypatch, fault):
    _plant(monkeypatch, fault)
    line = _run(late_root)
    assert not line["correct"], line["compared"]


def test_traced_run_reports_the_moe_metrics(late_root):
    line = _run(late_root, trace=True)
    assert line["correct"], line["compared"]
    assert line["metrics"]["expert_load_ratio.late"]["value"] >= 1.0
    assert line["metrics"]["moe_idle_pct.late"]["value"] >= 0.0
    assert "expert_roofline_pct.late" not in line["metrics"]  # no card, no device time


def test_counts_at_the_published_widths():
    """4.49 GFLOP a token through the language model and the head, the MoE
    layers about 65% of a page's operations and the routed experts 48%."""
    token = yardstick_moe.token_flops(FULL)
    assert token == pytest.approx(4.486e9, rel=1e-3)
    assert yardstick_moe.page_tokens(FULL) == 1030
    page = 1030 * token + yardstick_moe.vision_flops(FULL) + yardstick_moe.attention_work(FULL, [1030])[0]
    routed = 1030 * 26 * 6 * yardstick_moe.expert_flops(FULL)
    shared = 1030 * 26 * 2 * 3 * 2048 * 2816
    assert 0.45 < routed / page < 0.51 and 0.62 < (routed + shared) / page < 0.68
    flops, nbytes = yardstick_moe.expert_work(FULL, 8 * 1030)
    assert flops == 8 * 1030 * 6 * 2 * 3 * 2048 * 1408
    assert nbytes == (64 * 3 * 2048 * 1408 + 2 * 8 * 1030 * 6 * 2048) * 2
    pairs = 1030 * 1031 // 2
    assert yardstick_moe.attention_work(FULL, [1030])[0] == 27 * 2.0 * pairs * 16 * (192 + 128)


def test_load_ratio_reader_averages_the_layers():
    reader = Bench(ROOT).metric("expert_load_ratio.late")

    class Run:
        profiled = [{"expert_loads": np.array([[4, 0, 0, 0], [1, 1, 1, 1]])},
                    {"expert_loads": np.array([[2, 2, 0, 0], [0, 0, 0, 0]])}]

    assert reader.read(Run()) == pytest.approx((4.0 + 1.0 + 2.0) / 3)
    Run.profiled = [{"expert_loads": None}]
    assert reader.read(Run()) is None


def test_reference_follows_the_outputs_it_is_held_against(late_root):
    """The f32 reference refuses to run without outputs to follow, and a
    forced expert far from the router's choice reads a large margin."""
    bench = Bench(late_root)
    cell = bench.cell(CELL, SEED, "cpu", False)
    session = bench.driver(cell).Session(cell)
    with pytest.raises(RuntimeError, match="follows"):
        session.reference([], "f32")
    from perfbench.reference import colpali_moe

    cfg = cell.config
    g = torch.Generator().manual_seed(5)  # unseeded, a row whose scores all saturate near 1 read no far expert
    x = torch.randn(5, cfg["hidden_size"], generator=g)
    w = torch.randn(cfg["n_routed_experts"], cfg["hidden_size"], generator=g)
    layer = {"p.gate.weight": w, "p.gate.e_score_correction_bias": torch.zeros(cfg["n_routed_experts"])}
    for e in range(cfg["n_routed_experts"]):
        for proj, shape in (("gate_proj", (32, 64)), ("up_proj", (32, 64)), ("down_proj", (64, 32))):
            layer[f"p.experts.{e}.{proj}.weight"] = torch.zeros(shape)
    for proj, shape in (("gate_proj", (64, 64)), ("up_proj", (64, 64)), ("down_proj", (64, 64))):
        layer[f"p.shared_experts.{proj}.weight"] = torch.zeros(shape)
    _, own, margin = colpali_moe.moe(x, layer, "p", cfg, "f32")
    assert not margin.any()
    worst = torch.sigmoid(x @ w.T).argsort(dim=-1)[:, :2]
    _, _, margin = colpali_moe.moe(x, layer, "p", cfg, "f32", forced=worst)
    assert (margin > 0.05).all()
