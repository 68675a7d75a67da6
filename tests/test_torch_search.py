"""The port's retrieval search and its two CLIs against the JAX package's,
on the CPU.

Four indexes: a dense (debug OpenAI-CLIP-L) and a multi-vector (debug
ColPali-v1.3) one, each built by each package's ``cli/encode_cli.py`` (the
same ``.npz`` keys and dtypes). Each index is searched by both packages'
``Index`` with the same query embeddings: the ids are equal and the scores
agree to 1e-5 (f32 sums in another order). A multi-vector index is f32, so
the port scores it with the f32 MaxSim path, casting bf16 queries to f32 as
the JAX reference does. Ties break as ``jax.lax.top_k`` breaks them, the lower
index first (tolerance 0 on the ids).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.cli.encode_cli import main as jax_encode_main
from multimodal_embedding_tpu.retrieval.search import Index as JaxIndex
from multimodal_embedding_tpu_torch.cli.encode_cli import main as encode_main
from multimodal_embedding_tpu_torch.cli.search import main as search_main
from multimodal_embedding_tpu_torch.retrieval.search import Index
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    out = {}
    for model in ("OpenAI-CLIP-L", "ColPali-v1.3"):
        args = ["--model", model, "--dataset", "synthetic", "--sample-size", "10", "--debug-models"]
        out[model, "jax"] = d / f"{model}_jax.npz"
        out[model, "port"] = d / f"{model}_port.npz"
        assert jax_encode_main([*args, "--output", str(out[model, "jax"])]) == 0
        assert encode_main([*args, "--device", "cpu", "--output", str(out[model, "port"])]) == 0
    return out


@pytest.mark.parametrize("model", ["OpenAI-CLIP-L", "ColPali-v1.3"])
def test_encode_cli_writes_the_jax_keys(indexes, model):
    with np.load(indexes[model, "jax"]) as want, np.load(indexes[model, "port"]) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got["imgids"], want["imgids"])
        np.testing.assert_array_equal(got["caption_image_index"], want["caption_image_index"])
        if model == "OpenAI-CLIP-L":
            np.testing.assert_allclose(np.linalg.norm(got["image_embeddings"], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("written_by", ["jax", "port"])
@pytest.mark.parametrize("model", ["OpenAI-CLIP-L", "ColPali-v1.3"])
def test_index_search_matches_jax(indexes, model, written_by):
    path = str(indexes[model, written_by])
    with np.load(path) as data:
        queries = data["text_embeddings"][:12]
        mask = data["text_masks"][:12] if "text_masks" in data.files else None
    jidx, tidx = JaxIndex.from_npz(path), Index.from_npz(path, device="cpu")
    assert tidx.multi_vector == jidx.multi_vector == (model == "ColPali-v1.3")
    assert tidx.embeddings.dtype == torch.float32
    # the engines give multi-vector queries in bf16
    jq = jnp.asarray(queries, jnp.bfloat16) if jidx.multi_vector else jnp.asarray(queries)
    tq = torch.from_numpy(queries).to(torch.bfloat16) if tidx.multi_vector else torch.from_numpy(queries)
    want_ids, want_scores = jidx.search(jq, k=5, query_mask=None if mask is None else jnp.asarray(mask))
    got_ids, got_scores = tidx.search(tq, k=5, query_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=1e-5, rtol=0)


def test_ties_break_lower_index_first():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    docs = base[[0, 1, 0, 2, 1, 0, 3, 2]]  # duplicate rows: exact ties
    ids = np.arange(100, 108)
    queries = base[[0, 1, 2]]
    want_ids, want_scores = JaxIndex(jnp.asarray(docs), ids).search(jnp.asarray(queries), k=8)
    got_ids, got_scores = Index(torch.from_numpy(docs), ids).search(torch.from_numpy(queries), k=8)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_ids[0, :3], [100, 102, 105])
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=1e-5, rtol=0)
    # multi-vector: equal docs, equal MaxSim scores
    mdocs = np.stack([docs, docs[::-1]], axis=1)  # [8, 2, 8]
    mq = queries[:, None, :]
    want_ids, _ = JaxIndex(jnp.asarray(mdocs), ids, multi_vector=True).search(jnp.asarray(mq), k=8)
    got_ids, _ = Index(torch.from_numpy(mdocs), ids, multi_vector=True).search(torch.from_numpy(mq), k=8)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_search_cli(indexes, capsys):
    rc = search_main(["--index", str(indexes["ColPali-v1.3", "port"]), "--model", "ColPali-v1.3",
                      "--debug-models", "--query", "a red dog", "--query", "kitchen", "--k", "3", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "query: a red dog" in out and "query: kitchen" in out
    assert len([line for line in out.splitlines() if line.startswith("  ")]) == 6
