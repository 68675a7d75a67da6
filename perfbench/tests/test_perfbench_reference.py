"""The plain reference agrees with the port's CPU path at toy widths, in
float32: preprocessing, both towers of both families, the tokenizer and
the bootstrap's recall."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn
from multimodal_embedding_tpu_torch.stats.bootstrap import bootstrap_benchmark
from perfbench import generator
from perfbench.port import load_model
from perfbench.reference import preprocess, retrieval, tokenizer, towers
from perfbench.tests.tiny import CONFIGS
from perfbench.weights import make_state_dict


@pytest.fixture(params=sorted(CONFIGS))
def tiny(request):
    cfg = CONFIGS[request.param]()
    cfg["dtype"] = "float32"
    sd = make_state_dict(cfg, 11, device="cpu", dtype=torch.float32)
    return cfg, sd, load_model(cfg, sd, "cpu")


def _images(n=6, h=30, w=40):
    rng = np.random.default_rng(0)
    return generator.render(generator.records(n, rng), h, w, rng, torch.Generator().manual_seed(0), "cpu")


def test_preprocess_within_one_level(tiny):
    cfg, _, model = tiny
    imgs = _images()
    port = make_preprocess_fn(model.preprocess, 30, 40, device="cpu", input_format="nchw")(imgs)  # NHWC
    ref = preprocess.preprocess(imgs, cfg["preprocess"]).permute(0, 2, 3, 1)
    level = 1.0 / 255.0 / min(cfg["preprocess"]["std"])
    assert float((port - ref).abs().max()) <= level * 1.001
    assert float(((port - ref).abs() < 1e-5).float().mean()) > 0.99


def test_towers_match_the_port(tiny):
    cfg, sd, model = tiny
    engine = EncodingEngine(model, 4, device="cpu")
    imgs = _images()
    got = engine._image_batch(imgs, 30, 40)
    want = retrieval.l2_normalize(towers.image_embeddings(list(imgs), sd, cfg, "f32"))
    assert float(torch.nn.functional.cosine_similarity(got, want).min()) > 0.99999
    texts = [c for r in generator.records(3, np.random.default_rng(1)) for c in r["captions"]]
    got = engine.encode_texts(texts).embeddings
    want = retrieval.l2_normalize(towers.text_embeddings(texts, sd, cfg, "f32", "cpu"))
    assert float(torch.nn.functional.cosine_similarity(got, want).min()) > 0.99999


def test_tokenizer_is_the_ports(tiny):
    cfg, _, model = tiny
    texts = ["a photo of a red dog", "two " * 40, ""]
    ids, mask = model.tokenize(texts)
    tc = cfg["text_config"]
    rids, rmask = tokenizer.tokenize(texts, tc["vocab_size"], tc["max_position_embeddings"])
    assert np.array_equal(ids, rids.numpy()) and np.array_equal(mask, rmask.numpy())


def test_recall_matches_the_bootstrap():
    g = torch.Generator().manual_seed(0)
    n, k = 60, 5
    img = torch.nn.functional.normalize(torch.randn(n, 16, generator=g), dim=1)
    caps = torch.nn.functional.normalize(img.repeat_interleave(k, 0) + 0.3 * torch.randn(n * k, 16, generator=g), dim=1)
    caps[7] = caps[5]  # exact ties inside one image's block
    s_t2i, s_i2t = caps[::k] @ img.T, img @ caps.T
    out = bootstrap_benchmark(s_t2i, s_i2t, 4, seed=3, caps_per_image=k)
    metrics, hits = retrieval.bootstrap_round(s_t2i, s_i2t, torch.from_numpy(out.sample_idx.astype(np.int64)), k)
    assert list(metrics) == list(out.metrics)
    for name, v in metrics.items():
        assert out.metrics[name] == pytest.approx(v, abs=1e-4)
    assert np.array_equal(hits, out.correct_r1)
