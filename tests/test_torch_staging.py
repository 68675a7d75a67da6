"""The port's staging and transports against the JAX package's, on the CPU.

The same synthetic records (four geometries) and the same debug
OpenAI-CLIP-L weights (drawn by the JAX package, carried by
``params_from_jax``) go through both engines.

- ``AsyncImageStager``: the streaming encode and the cache that ``wait()``
  assembles are bit-equal (tolerance 0) to the cached path's embeddings and
  to ``stage_images``' cache; the streaming embeddings agree with the JAX
  package's ``encode_images_streaming`` to 1e-5 in f32 (f32 sums in another
  order).
- Host transport: ``host_resize_crop`` is bit-equal to the JAX package's (both
  are PIL); the host path's embeddings agree with the JAX host path's to 1e-5.
- The CLI: ``--overlap-staging`` (default), ``--no-overlap-staging`` and
  ``--streaming-encode`` give the same metric columns (tolerance 0: the same
  scores, the same bootstrap draws), and ``--transport host`` runs.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset
from multimodal_embedding_tpu.models.encode import AsyncImageStager as JaxStager
from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.ops.preprocess import host_resize_crop as jax_host_resize_crop
from multimodal_embedding_tpu.parallel.mesh import get_mesh
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models import encode
from multimodal_embedding_tpu_torch.models.encode import AsyncImageStager, EncodingEngine, stage_images
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test, model_info
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from multimodal_embedding_tpu_torch.ops.preprocess import host_resize_crop
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_IMAGES, BATCH, SEED = 20, 8, 42  # batch 8: the JAX engine rounds to its 8-device CPU mesh


@pytest.fixture(scope="module")
def pair():
    records = synthetic_retrieval_dataset(N_IMAGES, seed=SEED)
    (jinfo,) = jax_models("OpenAI-CLIP-L", BATCH)
    (tinfo,) = get_models_to_test("OpenAI-CLIP-L", BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    return [r["image"] for r in records], jmodel, tmodel


def test_stager_and_streaming_equal_the_cached_path(pair, monkeypatch):
    images, _, tmodel = pair
    monkeypatch.setattr(encode, "SLICE_BYTES", 1)  # one batch a slice: several slices a geometry
    engine = EncodingEngine(tmodel, 4, device="cpu")
    cache = stage_images(images, 4, "cpu")
    want = engine.encode_images_cached(cache).embeddings
    stager = AsyncImageStager(images, 4, "cpu")
    assert len(stager.slice_plan) > len(cache.groups)
    assert stager.slice_shapes() == sorted({(h, w, 1) for (h, w), _, _ in stager.slice_plan})
    engine.warmup_streaming(stager)
    got = engine.encode_images_streaming(stager)
    assert torch.equal(got.embeddings, want) and got.seconds > 0
    assembled = stager.wait()
    assert stager.wait() is assembled
    assert [(g[0], g[1], g[3]) for g in assembled.groups] == [(g[0], g[1], g[3]) for g in cache.groups]
    assert all(torch.equal(a[2], b[2]) for a, b in zip(assembled.groups, cache.groups))
    assert torch.equal(engine.encode_images_cached(assembled).embeddings, want)


def test_slice_plan_holds_whole_batches():
    images = [np.zeros((480, 640, 3), np.uint8)] * 10 + [np.zeros((64, 64, 3), np.uint8)] * 3
    groups, plan = encode._group_layout(images, 4)
    assert list(groups) == [(480, 640), (64, 64)]
    per_slice = max(1, encode.SLICE_BYTES // (4 * 3 * 480 * 640))
    assert [p for p in plan if p[0] == (480, 640)] == [((480, 640), s, min(per_slice, 3 - s))
                                                       for s in range(0, 3, per_slice)]
    assert [p for p in plan if p[0] == (64, 64)] == [((64, 64), 0, 1)]


def test_stager_surfaces_a_staging_failure():
    stager = AsyncImageStager([np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8), np.uint8)], 2, "cpu")
    with pytest.raises(Exception):
        list(stager.chunks())
    with pytest.raises(Exception):
        stager.wait()


def test_streaming_matches_jax(pair):
    images, jmodel, tmodel = pair
    mesh = get_mesh()
    jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
    jstager = JaxStager(images, mesh, BATCH)
    jengine.warmup_streaming(jstager)
    want = np.asarray(jengine.encode_images_streaming(jstager).embeddings)
    jstager.wait()
    engine = EncodingEngine(tmodel, BATCH, device="cpu")
    got = engine.encode_images_streaming(AsyncImageStager(images, BATCH, "cpu")).embeddings
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["OpenAI-CLIP-L", "SigLIP-400M", "ColPali-v1.3", "LAION-CLIP-H", "Jina-CLIP-v1"])
def test_host_resize_crop_bit_equal_to_jax(name):
    from multimodal_embedding_tpu.models.registry import model_info as jax_model_info

    rng = np.random.default_rng(0)
    for h, w in ((480, 640), (427, 640), (500, 333), (64, 64)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = host_resize_crop(model_info(name).preprocess, img)
        want = jax_host_resize_crop(jax_model_info(name).preprocess, img)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_host_transport_matches_jax(pair):
    images, jmodel, tmodel = pair
    jengine = JaxEngine(jmodel, get_mesh(), batch_size=BATCH, transport="host", host_workers=4)
    want = np.asarray(jengine.encode_images(images).embeddings)
    engine = EncodingEngine(tmodel, BATCH, device="cpu", transport="host", host_workers=4)
    assert engine.transport == "host"
    got = engine.encode_images(images).embeddings
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rate, want", [(999.0, "host"), (1000.0, "device")])
def test_auto_transport_follows_the_measured_rate(pair, monkeypatch, rate, want):
    monkeypatch.setattr(encode, "measure_put_bandwidth_mbps", lambda device: rate)
    assert EncodingEngine(pair[2], BATCH, device="cpu").transport == want


def test_put_bandwidth_is_measured_once_a_device():
    first = encode.measure_put_bandwidth_mbps("cpu")
    assert first > 0 and encode.measure_put_bandwidth_mbps("cpu") == first


def _cli(tmp_path, name, *flags):
    out = tmp_path / f"{name}.csv"
    assert tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "OpenAI-CLIP-L",
                      "--sample-size", "16", "--bootstrap-iterations", "8", "--batch-size", "8",
                      "--output", str(out), *flags]) == 0
    return pd.read_csv(out)


def test_cli_staging_modes_give_the_same_metrics(tmp_path, monkeypatch):
    monkeypatch.setattr(encode, "SLICE_BYTES", 1)
    joined = _cli(tmp_path, "overlap")  # --overlap-staging is the default
    metric_cols = [c for c in joined.columns if "_R@" in c]
    for name, flags in (("upfront", ["--no-overlap-staging"]), ("streaming", ["--streaming-encode"]),
                        ("streaming2", ["--streaming-encode", "--encode-passes", "2"])):
        df = _cli(tmp_path, name, *flags)
        assert list(df.columns) == list(joined.columns)
        assert df[metric_cols].equals(joined[metric_cols]), name
        assert float(df["QPS"][0]) > 0


def test_cli_overlap_joins_staging_before_the_timed_encode(tmp_path, monkeypatch):
    """Without --streaming-encode the first model warms its text sweeps while
    the stager uploads, then joins it and takes the cached path: no
    streaming encode runs."""
    calls = []
    monkeypatch.setattr(EncodingEngine, "encode_images_streaming",
                        lambda self, stager: calls.append("streaming"))
    wait = AsyncImageStager.wait
    monkeypatch.setattr(AsyncImageStager, "wait", lambda self: (calls.append("wait"), wait(self))[1])
    _cli(tmp_path, "joined")
    assert calls and set(calls) == {"wait"}


def test_cli_host_transport(tmp_path):
    df = _cli(tmp_path, "host", "--transport", "host", "--no-device-cache")
    assert float(df["QPS"][0]) > 0
