"""The encode cells' readers of the port's own spans and counters
(``multimodal_embedding_tpu_torch/utils/profiling.py``) at toy size on the
CPU: a traced run reports all four, the padded-row share is the traffic's
own, and the idle time the trace names by the tokenizer's range is read."""

from __future__ import annotations

import time

import pytest

from perfbench import port
from perfbench.harness import Bench, run
from perfbench.tests.tiny import CONFIGS, TRAFFIC

CELL = "tiny-clip.tiny-encode"
SEED = 2**31 + 11
NEW = ("tokenize_ms.encode", "tokenize_idle_pct.encode", "text_pad_pct.encode", "image_pad_pct.encode")
SLOW_S = 0.5  # the caption sweep's tokenization, many times the rest of a toy round


def _traffic_pad_pct() -> float:
    """Padded rows over rows of the traffic's batches: each cache's records
    split over the geometries (record i to geometry i mod G), each group in
    padded batches of the configuration's batch size."""
    tr, batch = TRAFFIC["tiny-encode"], CONFIGS["tiny-clip"]()["batch_size"]
    per, n_geom = tr["images"] // tr["caches"], len(tr["geometries"])
    groups = [len(range(g, per, n_geom)) for g in range(n_geom)]
    rows = sum(-(-n // batch) * batch for n in groups)
    return 100.0 * (rows - per) / rows


@pytest.fixture
def slow_caption_sweep(monkeypatch):
    """The port's tokenizer, slowed on the caption sweep (its texts outnumber
    the images). On the CPU the trace has no device activity, so the traced
    stretch is one idle gap, named by the range open at its middle: the slow
    sweep holds that middle."""
    images = TRAFFIC["tiny-encode"]["images"] // TRAFFIC["tiny-encode"]["caches"]
    plain = port.arch_tokenizer

    def slowed(info, cfg):
        tokenize = plain(info, cfg)

        def slow(texts):
            if len(texts) > images:
                time.sleep(SLOW_S)
            return tokenize(texts)

        return slow

    monkeypatch.setattr(port, "arch_tokenizer", slowed)


def test_a_traced_run_reads_the_ports_spans_and_counts(tiny_root, slow_caption_sweep):
    bench = Bench(tiny_root)
    line = run(bench, bench.cell(CELL, SEED, "cpu", True), 0.2, 0.0, device_name="cpu")
    metrics = {n: line["metrics"][n]["value"] for n in NEW}
    assert line["correct"], line["compared"]
    assert metrics["image_pad_pct.encode"] == pytest.approx(_traffic_pad_pct())
    assert 0 < metrics["text_pad_pct.encode"] < 100
    assert metrics["tokenize_ms.encode"] >= 1e3 * SLOW_S
    assert metrics["tokenize_idle_pct.encode"] > 0
    assert line["breakdown"]["idle_gaps"][0][0] == "mme.encode.tokenize"

