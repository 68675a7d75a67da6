"""The result line's keys, a run that finds no card, and a run that loads
JAX after its window."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from perfbench import harness
from perfbench import run as run_mod
from perfbench.harness import Bench, describe, run


def test_line_has_the_contract_keys(tiny_root):
    bench = Bench(tiny_root)
    for trace in (False, True):
        line = run(bench, bench.cell("tiny-clip.tiny-stats", 2**31 + 5, "cpu", trace), 0.2, 0.0, device_name="cpu")
        keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["compared"]
        assert list(line) == keys
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        json.loads(json.dumps(line))
        assert all(row.startswith("compared ") for row in describe(line["compared"]))


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "clip-l.coco-encode", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_jax_loaded_during_the_check_gives_no_line(tiny_root, monkeypatch):
    bench = Bench(tiny_root)
    orig = harness.check

    def loads_jax(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(*a, **kw)

    monkeypatch.setattr(harness, "check", loads_jax)
    with pytest.raises(RuntimeError, match="jax"):
        run(bench, bench.cell("tiny-clip.tiny-stats", 7, "cpu", False), 0.2, 0.0, device_name="cpu")


def test_jax_loaded_before_the_print_gives_no_line(monkeypatch, capsys):
    """run.py looks again just before it prints."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")

    def fake_run(*a, **kw):
        monkeypatch.setitem(sys.modules, "multimodal_embedding_tpu", types.ModuleType("multimodal_embedding_tpu"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}, "compared": {}}

    monkeypatch.setattr(harness, "run", fake_run)
    with pytest.raises(RuntimeError, match="multimodal_embedding_tpu"):
        run_mod.main(["--workload", "clip-l.coco-encode", "--seed", "1", "--seconds", "1"])
    assert capsys.readouterr().out == ""
