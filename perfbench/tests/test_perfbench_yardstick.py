"""The operation and byte counts against hand counts."""

from __future__ import annotations

import json

import pytest

from perfbench import yardstick
from perfbench.harness import ROOT

CLIP = json.loads((ROOT / "perfbench" / "configs" / "clip-l.json").read_text())


def test_one_vit_l_layer():
    t, d, mlp = 577, 1024, 4096
    gemm = 2 * t * d * 3 * d + 2 * t * d * d + 2 * t * d * mlp * 2
    attn = 2 * t * t * d * 2  # QK^T and PV, all 16 heads of 64
    layer = (yardstick.image_flops(CLIP) - 2 * 576 * 588 * 1024 - 2 * 1024 * 768) / 24
    assert layer == pytest.approx(gemm + attn, rel=1e-12)
    assert yardstick.image_flops(CLIP) == pytest.approx(0.38e12, rel=0.02)


def test_one_attention_launch():
    flops, nbytes = yardstick.image_attention_work(CLIP, 32)[0]
    assert flops == 32 * 24 * 4 * 577 * 577 * 1024
    assert nbytes == 32 * 24 * 4 * 577 * 1024 * 2  # q, k, v read and o written once, bf16
    # a caption of 5 valid tokens under the causal and key masks: rows 0-4 attend 1..5 keys, 72 rows attend 5
    assert yardstick.attention_pairs_causal_masked(77, 5) == 15 + 72 * 5
    f, b = yardstick.text_attention_work(CLIP, [5])
    assert f == 12 * 4 * (15 + 72 * 5) * 768 and b == 12 * (4 * 77 * 768 * 2 + 4 * 77)


def test_one_bootstrap_chunk():
    n, k = 5000, 5
    per_iteration = k * 2 * (k * n) * n + 2 * 2 * n * n
    assert yardstick.bootstrap_iteration_flops(n, k) == per_iteration
    assert 250 * per_iteration == pytest.approx(250 * 1.35e9, rel=1e-12)


def test_preprocess_bytes_and_bound():
    assert yardstick.preprocess_bytes((480, 640), 336) == 480 * 640 * 3 + 336 * 336 * 3 * 4
    peaks = yardstick.peaks_for("NVIDIA H100 80GB HBM3")
    assert yardstick.bound_s(989e12, 0.0, peaks) == pytest.approx(1.0)
    assert yardstick.bound_s(0.0, 3.35e12, peaks) == pytest.approx(1.0)
    assert yardstick.peaks_for("cpu") is None
