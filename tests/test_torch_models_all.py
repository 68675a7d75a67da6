"""``--models all`` through the port: the seven registry models on the CPU at
their debug configs, the encode engine's embeddings for SigLIP-400M and
Jina-CLIP-v1 against the JAX engine's, and the arch tokenizers' ids.

Weights are drawn by the JAX package and carried into the port by
``params_from_jax``; tolerance 1e-4 absolute, as in ``tests/test_torch_slice.py``.
"""

import math

import jax
import numpy as np
import pandas as pd
import pytest

from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset
from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
from multimodal_embedding_tpu.models.encode import stage_images as jax_stage_images
from multimodal_embedding_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import hash_tokenizer as jax_hash_tokenizer
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.parallel.mesh import get_mesh
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models.arch import arch_tokenizer, full_arch_config, full_jina_config
from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test, model_info
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model

N_IMAGES, BATCH, SEED = 12, 8, 42
RECALL_COLUMNS = [f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
                  for s in ("mean", "lower", "upper")]


def test_cli_runs_all_seven_models(tmp_path):
    out = tmp_path / "all.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "all",
                    "--sample-size", "8", "--bootstrap-iterations", "4", "--batch-size", "4",
                    "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    assert list(df["Model"]) == [m.name for m in JAX_REGISTRY]
    want_cols = ["Model", "Weights"] + [
        f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
        for s in ("mean", "lower", "upper", "std")
    ] + ["Time", "QPS", "Encoding_Time", "Img_per_sec", "_failure_analysis"]
    assert list(df.columns) == want_cols
    assert (df["Weights"] == "debug-random").all()
    for col in RECALL_COLUMNS:
        assert all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in df[col]), col
    assert (df["QPS"] > 0).all()


@pytest.mark.parametrize("name", ["SigLIP-400M", "Jina-CLIP-v1"])
def test_engine_embeddings_match_jax(name):
    records = synthetic_retrieval_dataset(N_IMAGES, seed=SEED)
    (jinfo,) = jax_models(name, BATCH)
    (tinfo,) = get_models_to_test(name, BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    mesh = get_mesh()
    jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
    tengine = EncodingEngine(tmodel, BATCH, device="cpu")
    images = [r["image"] for r in records]
    got = tengine.encode_images_cached(stage_images(images, BATCH, "cpu")).embeddings
    want = jengine.encode_images_cached(jax_stage_images(images, mesh, BATCH)).embeddings
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    caps = [c for r in records for c in r["captions"]]
    np.testing.assert_allclose(tengine.encode_texts(caps).embeddings.numpy(),
                               np.asarray(jengine.encode_texts(caps).embeddings), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["SigLIP-400M", "SigLIP-Base", "OpenAI-CLIP-L", "LAION-CLIP-H"])
def test_arch_tokenizer_ids_are_the_rows_jax_reads(name):
    """Every id is a row of the text table; where the JAX package's id
    (49407) is past the end of SigLIP's 32000 rows, the port's is the row
    JAX's clamped gather reads."""
    cfg = full_arch_config(name)
    texts = ["a red car on a road", "dog", " ".join(["word"] * 100)]
    ids, mask = arch_tokenizer(model_info(name), cfg)(texts)
    jids, jmask = jax_hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, 49407)(texts)
    assert ids.max() < cfg.text.vocab_size
    np.testing.assert_array_equal(ids, np.minimum(jids, cfg.text.vocab_size - 1))
    np.testing.assert_array_equal(mask, jmask)


def test_arch_jina_tokenizer_ids_in_range():
    cfg = full_jina_config()
    ids, mask = arch_tokenizer(model_info("Jina-CLIP-v1"), cfg)(["a red car", "dog"])
    assert ids.shape == (2, 512) and ids.max() < cfg.text.vocab_size
    assert mask.sum(axis=1).tolist() == [5, 3]
