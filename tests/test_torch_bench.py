"""The port bench's one-JSON-line contract, on the CPU.

``python -m multimodal_embedding_tpu_torch.bench`` prints exactly one JSON
line on every exit path: on success the metric, a positive value, the unit,
``vs_baseline`` against the A40's 60.6 img/s and the device; on failure
``"value": null`` with the error, and exit code 1. The success run here is
the bench's own code at a debug size (the debug OpenAI-CLIP-L model, 6
images, batch 3, one timed pass) with ``--device cpu``; the number is no
device measurement.
"""

import json

import pytest
import torch

from multimodal_embedding_tpu_torch import bench
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _one_line(capsys) -> dict:
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_success_line_at_a_debug_size(capsys, monkeypatch):
    monkeypatch.setattr(bench, "N_IMAGES", 6)
    monkeypatch.setattr(bench, "BATCH", 3)
    monkeypatch.setattr(bench, "PASSES", 1)
    monkeypatch.setattr(bench, "bench_model", lambda device: load_debug_model(model_info(bench.MODEL), device=device))
    assert bench.main(["--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "device"]
    assert line["metric"] == "clip_l_encode_images_per_sec" and line["unit"] == "img/s"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 60.6)
    assert line["device"] == "cpu"


def test_forced_failure_line(capsys, monkeypatch):
    def boom(device):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(bench, "run_once", boom)
    assert bench.main(["--device", "cpu"]) == 1
    line = _one_line(capsys)
    assert line == {"metric": bench.METRIC, "value": None, "unit": "img/s", "vs_baseline": None,
                    "error": "RuntimeError: kernel build failed"}


def test_no_card_is_a_failure_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    line = _one_line(capsys)
    assert line["value"] is None and "CUDA is not available" in line["error"]


def test_bench_workload_is_the_jax_benchs():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("jax_bench", Path(__file__).resolve().parent.parent / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    assert (bench.METRIC, bench.UNIT, bench.BASELINE_CLIP_L_QPS, bench.N_IMAGES, bench.BATCH, bench.PASSES) == (
        jax_bench.METRIC, jax_bench.UNIT, jax_bench.BASELINE_CLIP_L_QPS, jax_bench.N_IMAGES, jax_bench.BATCH,
        jax_bench.PASSES)
