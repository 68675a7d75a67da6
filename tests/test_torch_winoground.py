"""The port's Winoground evaluator against the JAX package's, on the CPU.

Both packages load the same synthetic Winoground records, and the same debug
weights (drawn by the JAX package, carried by ``params_from_jax``) encode
them. The percentages are equal (tolerance 0) for debug OpenAI-CLIP-L
(dense scores, one f32 matmul). For debug ColPali-v1.3 (MaxSim scores) the
reference is the JAX engine with its NaN pad-token embeddings mapped to 0
(ROADMAP.md section 3: the JAX engine's second normalization turns COMPAT
#8's zero pads into NaN), as ``tests/test_torch_colpali_slice.py`` holds it.
The predicates are also checked on a hand-built score matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.analysis.winoground import load_winoground as jax_load_winoground
from multimodal_embedding_tpu.analysis.winoground import run_winoground as jax_run_winoground
from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.parallel.mesh import get_mesh
from multimodal_embedding_tpu_torch.analysis.winoground import load_winoground, run_winoground
from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_SAMPLES, BATCH, SEED = 8, 8, 42


def test_synthetic_records_are_the_jax_packages():
    got, want = load_winoground(N_SAMPLES, synthetic=True), jax_load_winoground(N_SAMPLES, synthetic=True)
    assert len(got) == len(want) == N_SAMPLES
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["caption_0"] == w["caption_0"] and g["caption_1"] == w["caption_1"]
        assert np.array_equal(g["image_0"], w["image_0"]) and np.array_equal(g["image_1"], w["image_1"])


class _NanToZero:
    """The JAX engine with NaN embedding elements mapped to 0."""

    def __init__(self, engine):
        self.engine, self.model = engine, engine.model

    def encode_images(self, images):
        res = self.engine.encode_images(images)
        res.embeddings = jnp.nan_to_num(res.embeddings)
        return res

    def encode_texts(self, texts):
        res = self.engine.encode_texts(texts)
        res.embeddings = jnp.nan_to_num(res.embeddings)
        return res


@pytest.mark.parametrize("name", ["OpenAI-CLIP-L", "ColPali-v1.3"])
def test_percentages_equal_jax(name):
    records = load_winoground(N_SAMPLES, synthetic=True)
    (jinfo,) = jax_models(name, BATCH)
    (tinfo,) = get_models_to_test(name, BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    jengine = JaxEngine(jmodel, get_mesh(), batch_size=BATCH, transport="device")
    want = jax_run_winoground(_NanToZero(jengine) if jmodel.multi_vector else jengine, records)
    got = run_winoground(EncodingEngine(tmodel, BATCH, device="cpu"), records)
    assert list(got) == ["Wino Text", "Wino Image", "Wino Group"]
    assert got == want


def test_predicates_on_a_hand_built_matrix():
    """Example 0 pairs correctly; in example 1, c0.i0 = 0.96 < c0.i1 = 1.0
    (text fails) and c1.i0 = 1.0 > c0.i0 (image fails)."""

    class Result:
        def __init__(self, rows):
            self.embeddings = torch.tensor(rows)

    class FakeEngine:
        class model:
            multi_vector = False

        def encode_images(self, images):  # all image_0s, then all image_1s
            return Result([[1.0, 0.0], [0.6, 0.8], [0.0, 1.0], [0.8, 0.6]])

        def encode_texts(self, texts):
            return Result([[1.0, 0.0], [0.8, 0.6], [0.0, 1.0], [0.6, 0.8]])

    records = [{"image_0": None, "image_1": None, "caption_0": "a", "caption_1": "b"},
               {"image_0": None, "image_1": None, "caption_0": "c", "caption_1": "d"}]
    assert run_winoground(FakeEngine(), records) == {"Wino Text": 50.0, "Wino Image": 50.0, "Wino Group": 50.0}
    assert run_winoground(FakeEngine(), []) == {}
