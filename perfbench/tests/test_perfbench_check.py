"""``correct`` at toy sizes on the CPU: sound runs of the port pass; the
control (the reference one precision down, in the port's place) fails; and
each fault a cell can have, planted under the timed path, fails. The faults:
a step that returns its state unchanged (the previous unit's answer), half
of the batch left out with the mean of the rest in its place, and an answer
altered where it is produced; in the statistics phase also intervals from
fewer resamples or at another percentile, and a failure analysis over half
of the iterations. No cell here spans chips, so the exchange between chips
has no fault to plant."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
from multimodal_embedding_tpu_torch.retrieval import search as search_mod
from perfbench.harness import Bench, Reservoir, check, measure, run, verdict

ENCODE = ["tiny-clip.tiny-encode", "tiny-siglip.tiny-encode"]
CELLS = ENCODE + ["tiny-clip.tiny-stats", "tiny-clip.tiny-search"]
SEED = 2**31 + 11


def _line(root, name, seconds=0.5):
    bench = Bench(root)
    return run(bench, bench.cell(name, SEED, "cpu", False), seconds, 0.0, device_name="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    line = _line(tiny_root, name)
    assert line["correct"], line["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_root, name):
    bench = Bench(tiny_root)
    cell = bench.cell(name, SEED, "cpu", False)
    driver = bench.driver(cell)
    session = driver.Session(cell)
    session.warmup()
    records = measure(session, cell, 0.3)[0]
    session.free()
    correct, compared = verdict(check(session, records, cell, driver.CONTROL), cell.limits)
    assert not correct, compared


def _stale(method_owner, name):
    """Plant: each call returns the previous call's answer."""
    orig = getattr(method_owner, name)
    last = {}

    def stale(self, *a, **kw):
        out = orig(self, *a, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return stale


def _half_mean(rows: torch.Tensor) -> torch.Tensor:
    keep = -(-rows.shape[0] // 2)
    out = rows.clone()
    out[keep:] = torch.nn.functional.normalize(rows[:keep].float().mean(0), dim=0).to(rows.dtype)
    return out


def _encode_faults(monkeypatch, fault):
    if fault == "stale":
        monkeypatch.setattr(EncodingEngine, "encode_images_cached", _stale(EncodingEngine, "encode_images_cached"))
    elif fault == "half":
        orig = EncodingEngine._image_batch
        monkeypatch.setattr(EncodingEngine, "_image_batch", lambda self, *a: _half_mean(orig(self, *a)))
    else:
        orig = EncodingEngine._image_batch

        def altered(self, *a):
            out = orig(self, *a).clone()
            out[0] = -out[0]
            return out

        monkeypatch.setattr(EncodingEngine, "_image_batch", altered)


def _stats_faults(monkeypatch, fault, driver):
    orig = driver.bootstrap_benchmark
    if fault == "stale":
        last = {}

        def stale(*a, **kw):
            out = orig(*a, **kw)
            prev = last.get("out", out)
            last["out"] = out
            return prev

        monkeypatch.setattr(driver, "bootstrap_benchmark", stale)
        return

    def planted(*a, **kw):
        out = orig(*a, **kw)
        for name, values in out.metrics.items():
            if fault == "half":
                half = len(values) // 2
                values[half:] = values[:half].mean()
            elif name == "T2I_R@1":
                values += 100.0 / out.sample_idx.shape[1]  # one query's hit, in every iteration
        return out

    monkeypatch.setattr(driver, "bootstrap_benchmark", planted)


def _search_faults(monkeypatch, fault):
    if fault == "stale":
        orig, last = search_mod.Index.search, {}

        def stale(self, queries, *a, **kw):  # the previous request's answer, row by row
            out = orig(self, queries, *a, **kw)
            prev = last.get("out", out)
            last["out"] = out
            return tuple(np.resize(x, out[0].shape) for x in prev)

        monkeypatch.setattr(search_mod.Index, "search", stale)
    elif fault == "half":
        orig = EncodingEngine._text_batch
        monkeypatch.setattr(EncodingEngine, "_text_batch", lambda self, *a: _half_mean(orig(self, *a)))
    else:
        orig = search_mod.Index.search

        def altered(self, *a, **kw):
            ids, scores = orig(self, *a, **kw)
            ids = ids.copy()
            ids[:, 0] = (ids[:, 0] + 1) % len(self.ids)
            return ids, scores

        monkeypatch.setattr(search_mod.Index, "search", altered)


# The toy CLIP's image tower (two layers at width 64) maps every toy image
# to nearly one point, so the image-side faults are planted in the toy
# SigLIP; at full width CLIP-L's images lie apart (PERF.md).
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS[1:])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    bench = Bench(tiny_root)
    cell = bench.cell(name, SEED, "cpu", False)
    if name in ENCODE:
        _encode_faults(monkeypatch, fault)
    elif "stats" in name:
        _stats_faults(monkeypatch, fault, bench.driver(cell))
    else:
        _search_faults(monkeypatch, fault)
    line = run(bench, cell, 0.5, 0.0, device_name="cpu")
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("fault", ["resamples", "percentile", "failure"])
def test_statistics_fault_is_not_correct(tiny_root, monkeypatch, fault):
    bench = Bench(tiny_root)
    cell = bench.cell("tiny-clip.tiny-stats", SEED, "cpu", False)
    driver = bench.driver(cell)
    if fault == "resamples":
        monkeypatch.setattr(driver, "bootstrap_confidence_interval",
                            functools.partial(driver.bootstrap_confidence_interval, n_bootstrap=1000))
    elif fault == "percentile":
        monkeypatch.setattr(driver, "bootstrap_confidence_interval",
                            functools.partial(driver.bootstrap_confidence_interval, confidence=0.9))
    else:
        orig = driver.aggregate_failure_analysis

        def half(correct, idx, captions):
            keep = -(-len(correct) // 2)
            return orig(correct[:keep], idx[:keep], captions)

        monkeypatch.setattr(driver, "aggregate_failure_analysis", half)
    line = run(bench, cell, 0.5, 0.0, device_name="cpu")
    assert not line["correct"], line["compared"]


def test_reservoir_keeps_a_fixed_number_drawn_from_the_seed():
    def kept(seed, n=1000, size=4):
        res = Reservoir(size, np.random.default_rng(seed))
        for unit in range(n):
            res.offer(unit, unit * 10)
            assert len(res.slots) == min(unit + 1, size)
        return res.kept()

    assert kept(3) == kept(3) and kept(3) != kept(4)
    assert all(v == 10 * u for u, v in kept(3).items())
    assert list(kept(3, n=3)) == [0, 1, 2]
    counts = np.bincount([u for s in range(400) for u in kept(s, n=20)], minlength=20)
    assert counts.min() > 40 and counts.max() < 120  # each of 20 units kept about 80 times in 400


def test_limits_sit_between_readings(tiny_root):
    """The toy limits are some tenfold above the sound readings."""
    for name in CELLS:
        line = _line(tiny_root, name)
        for n, row in line["compared"].items():
            assert row["value"] <= row["limit"] / 3 or (row["value"] == 0.0), (name, n, row)
