"""The port's spans and counters (``utils/profiling.py``): free without a
profiler, ``mme.*`` ranges with their nesting under one, and the encoding
engine's row and position counts against counts made by hand."""

import json

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from multimodal_embedding_tpu_torch.parallel.mesh import Mesh
from multimodal_embedding_tpu_torch.utils import profiling
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS, Tally, maybe_trace
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("tally", [KERNELS, Tally()], ids=["kernels", "own"])
@pytest.mark.parametrize("name", ["kernel.fused_attention", "encode.tokenize"])
def test_a_span_without_a_profiler_is_the_shared_no_op(tally, name, monkeypatch):
    def no_range(*a, **kw):
        raise AssertionError("a range was made with no profiler running")

    monkeypatch.setattr(profiling, "_RANGE", no_range)
    monkeypatch.setattr(tally, "seconds", {})
    monkeypatch.setattr(tally, "n_spans", {})
    span = tally.span(name)
    assert span is profiling._OFF and tally.span("another") is span
    with span:
        torch.ones(2) + 1
    assert tally.seconds == {} and tally.n_spans == {}


@pytest.mark.parametrize("repeats", [1, 3])
def test_spans_under_a_profiler_nest_and_reach_the_tally(repeats):
    tally = Tally()
    with _cpu_profile() as prof:
        for _ in range(repeats):
            with tally.span("encode.texts"):
                with tally.span("encode.tokenize"):
                    torch.ones(3) + 1
                with tally.span("encode.text_batch"):
                    torch.ones(3) * 2
    events = [e for e in prof.events() if e.name.startswith("mme.")]
    parents = {e.name: e.cpu_parent.name if e.cpu_parent else None for e in events}
    assert parents == {"mme.encode.texts": None, "mme.encode.tokenize": "mme.encode.texts",
                       "mme.encode.text_batch": "mme.encode.texts"}
    assert len(events) == 3 * repeats
    assert tally.n_spans == {"encode.texts": repeats, "encode.tokenize": repeats, "encode.text_batch": repeats}
    assert tally.seconds["encode.texts"] >= tally.seconds["encode.tokenize"] + tally.seconds["encode.text_batch"] > 0
    assert tally.counts == {}


def test_counts_count_with_or_without_a_profiler():
    tally = Tally()
    tally.count("encode.image_rows", 4)
    with _cpu_profile():
        tally.count("encode.image_rows", 2)
    tally.count("encode.image_rows")
    assert tally.counts == {"encode.image_rows": 7}
    tally.reset()
    assert tally.counts == tally.seconds == tally.n_spans == {}


def test_the_written_trace_carries_the_ranges(tmp_path):
    tally = Tally()
    with maybe_trace(str(tmp_path)):
        with tally.span("encode.images"):
            torch.ones(2) + 1
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "mme.encode.images" in names and tally.n_spans == {"encode.images": 1}


@pytest.fixture(scope="module")
def model():
    return load_debug_model(model_info("OpenAI-CLIP-L"), seed=3, device="cpu")


def _images(shapes: list[tuple[int, int]]) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


@pytest.mark.parametrize("shapes,batch,rows,pad", [
    ([(48, 64)] * 5 + [(64, 48)] * 2, 4, 12, 5),  # groups of 5 and 2 in batches of 4: 3 + 2 padded
    ([(48, 64)] * 8, 4, 8, 0),
    ([(48, 64), (64, 48), (64, 64)], 2, 6, 3),
])
def test_the_engine_counts_padded_image_rows(model, shapes, batch, rows, pad):
    engine = EncodingEngine(model, batch, device="cpu", transport="device")
    engine.encode_images_cached(stage_images(_images(shapes), batch, "cpu"))
    assert {k: engine.tally.counts[k] for k in ("encode.image_rows", "encode.image_pad_rows")} == {
        "encode.image_rows": rows, "encode.image_pad_rows": pad}


@pytest.mark.parametrize("texts", [
    ["a cat", "two dogs on a red sofa", "x"],
    ["one"] * 130 + ["a much longer caption than the others by far"],  # two batches of 128
])
def test_the_engine_counts_text_pad_positions(model, texts):
    engine = EncodingEngine(model, 4, device="cpu", transport="device")
    engine.encode_texts(texts)
    length = model.cfg.text.max_len
    real = sum(min(len(t.split()), length - 2) + 2 for t in texts)  # BOS, the words, EOS
    assert engine.tally.counts == {"encode.text_positions": len(texts) * length,
                                   "encode.text_pad_positions": len(texts) * length - real}
    assert engine.tally.n_spans == {}  # no profiler: no span recorded


@pytest.mark.parametrize("rank,rows,real", [
    # 10 rows in batches of 8 over 2 data ranks, 4 rows a rank a batch:
    # rank 0 runs rows 0-3 and 8-11 (10, 11 pad), rank 1 rows 4-7 and 12-15 (all pad)
    (0, 8, 1 + 2 + 3 + 4 + 9 + 10),
    (1, 8, 5 + 6 + 7 + 8),
])
def test_each_data_rank_counts_its_own_text_rows(model, rank, rows, real):
    engine = EncodingEngine(model, 8, device="cpu", transport="device")
    engine.mesh = Mesh(n_data=2, n_model=1, data_rank=rank)
    mask = (np.arange(12)[None, :] < np.arange(1, 11)[:, None]).astype(np.int32)  # row i holds i + 1 tokens
    engine._count_text(mask, 8)
    assert engine.tally.counts == {"encode.text_positions": rows * 12, "encode.text_pad_positions": rows * 12 - real}


@pytest.mark.parametrize("rank,pad", [(0, 1), (1, 4)])
def test_each_data_rank_counts_its_own_image_rows(model, rank, pad):
    """A batch of 8 rows, 3 of them images, over 2 data ranks: rank 0 holds
    rows 0-3, rank 1 rows 4-7."""
    engine = EncodingEngine(model, 8, device="cpu", transport="device")
    engine.mesh = Mesh(n_data=2, n_model=1, data_rank=rank)
    engine._count_images(4, 3)
    assert engine.tally.counts == {"encode.image_rows": 4, "encode.image_pad_rows": pad}
