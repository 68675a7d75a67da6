"""The port's ColPali slice against the JAX package's, on the CPU.

The same synthetic records and the same debug ColPali weights (drawn by the
JAX package, carried by ``params_from_jax``) go through both packages'
encode -> MaxSim -> bootstrap -> CSV row.

The JAX engine normalizes ColPali's per-token output a second time with no
epsilon (``encode.py:305-307`` and ``:565``), so every zero pad vector that
``colpali_text_fwd`` leaves (COMPAT #8) becomes NaN there, and so does every
MaxSim score over them. The port keeps the pads exact zeros; the reference
here is the JAX engine's embeddings with NaN mapped to 0
(``jnp.nan_to_num``), which are COMPAT #8's zero pads.

Tolerances. Both engines store ColPali embeddings in bf16 (as the JAX
package does): f32 values that agree to about 1e-6 round to neighbouring
bf16 values in a few elements (6 of 4096 image elements at this size), so an
embedding may differ by one bf16 step (at most 2**-7 of its size) in under
1% of elements, else by at most 1e-4. Each such step moves a dot product of
unit vectors by at most 2**-7; the score matrices are held to 1e-2 absolute
against the JAX reference (about 2e-3 measured, scores up to about 5), and
the scoring step itself to 1e-5 of max|score| on identical embeddings. With
the JAX package's bootstrap samples and CI resamples replayed, each metric
agrees to within one query of N.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
from multimodal_embedding_tpu.models.encode import stage_images as jax_stage_images
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.ops.maxsim import maxsim_scores_ref as jax_maxsim_ref
from multimodal_embedding_tpu.parallel.mesh import get_mesh
from multimodal_embedding_tpu.stats.bootstrap import bootstrap_benchmark as jax_bootstrap
from multimodal_embedding_tpu.stats.ci import bootstrap_confidence_interval as jax_ci
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model

N_IMAGES, ITERS, BATCH, SEED = 32, 20, 16, 42
BF16_STEP = 2.0**-7  # one bf16 step, relative to the value


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def slice_pair():
    from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset

    records = synthetic_retrieval_dataset(N_IMAGES, seed=SEED)
    (jinfo,) = jax_models("ColPali-v1.3", BATCH)
    (tinfo,) = get_models_to_test("ColPali-v1.3", BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    mesh = get_mesh()
    images = [r["image"] for r in records]
    jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
    tengine = EncodingEngine(tmodel, BATCH, device="cpu")
    return (records, jmodel, tmodel, mesh, jengine, tengine,
            jax_stage_images(images, mesh, BATCH), stage_images(images, BATCH, "cpu"))


def _embeddings_close(got, want):
    """got: the port's bf16 tensor; want: the JAX engine's bf16 array with
    NaN mapped to 0."""
    got, want = got.float().numpy(), np.nan_to_num(_f32(want))
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert (diff <= 1e-4 + BF16_STEP * np.abs(want)).all()
    assert (got != want).mean() < 0.01


def _repaired_jax_scores(jengine, records, jcache):
    img = jengine.encode_images_cached(jcache).embeddings
    t2i = jengine.encode_texts([r["captions"][0] for r in records]).embeddings
    allc = jengine.encode_texts([c for r in records for c in r["captions"]]).embeddings
    fix = jnp.nan_to_num
    return jax_maxsim_ref(fix(t2i), fix(img)), jax_maxsim_ref(fix(img), fix(allc))


def test_embeddings_match_jax_with_exact_zero_pads(slice_pair):
    records, _, _, _, jengine, tengine, jcache, tcache = slice_pair
    _embeddings_close(tengine.encode_images_cached(tcache).embeddings,
                      jengine.encode_images_cached(jcache).embeddings)
    few = [r["image"] for r in records[:5]]
    _embeddings_close(tengine.encode_images(few).embeddings, jengine.encode_images(few).embeddings)
    caps = [c for r in records for c in r["captions"]]
    got, want = tengine.encode_texts(caps), jengine.encode_texts(caps)
    assert str(got.embeddings.dtype) == "torch.bfloat16"
    pads = got.mask.numpy() == 0
    assert pads.any()
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert (got.embeddings.float().numpy()[pads] == 0).all()
    _embeddings_close(got.embeddings, want.embeddings)


def test_score_matrices_match_repaired_jax_reference(slice_pair):
    records, _, tmodel, _, jengine, tengine, jcache, tcache = slice_pair
    want_t2i, want_i2t = _repaired_jax_scores(jengine, records, jcache)
    got_t2i, got_i2t, _ = tcli.compute_score_matrices(tmodel, tengine, records, cache=tcache)
    for got, want in ((got_t2i, want_t2i), (got_i2t, want_i2t)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    # the scoring step alone, on the port's embeddings
    img = tengine.encode_images_cached(tcache).embeddings
    t2i = tengine.encode_texts([r["captions"][0] for r in records]).embeddings
    want = np.asarray(jax_maxsim_ref(jnp.asarray(t2i.float().numpy()), jnp.asarray(img.float().numpy())))
    assert np.abs(got_t2i.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_csv_row_matches_repaired_jax_reference(slice_pair):
    records, _, tmodel, _, jengine, _, jcache, tcache = slice_pair
    s_t2i, s_i2t = _repaired_jax_scores(jengine, records, jcache)
    jout = jax_bootstrap(s_t2i, s_i2t, ITERS, seed=SEED)
    ci_idx = np.asarray(jax.random.randint(jax.random.key(0), (10_000, ITERS), 0, ITERS))
    got = tcli.run_bootstrap_benchmark(tmodel, records, ITERS, device="cpu", batch_size=BATCH, seed=SEED,
                                       cache=tcache, sample_idx=np.asarray(jout.sample_idx), ci_idx=ci_idx)
    one_query = 100.0 / N_IMAGES
    for key, values in jout.metrics.items():
        mean, lower, upper = jax_ci(np.asarray(values))
        for suffix, val in (("mean", mean), ("lower", lower), ("upper", upper)):
            assert np.isfinite(got[f"{key}_{suffix}"])
            assert abs(got[f"{key}_{suffix}"] - val) <= one_query + 1e-4, f"{key}_{suffix}"
    assert got["Weights"] == "debug-random"
    assert json.loads(got["_failure_analysis"])


def test_port_cli_writes_the_reference_schema_for_colpali(tmp_path):
    out = tmp_path / "colpali.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "ColPali-v1.3",
                    "--sample-size", "16", "--bootstrap-iterations", "8", "--batch-size", "8",
                    "--maxsim-impl", "pallas", "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    want_cols = ["Model", "Weights"] + [
        f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
        for s in ("mean", "lower", "upper", "std")
    ] + ["Time", "QPS", "Encoding_Time", "Img_per_sec", "_failure_analysis"]
    assert list(df.columns) == want_cols
    row = df.iloc[0]
    assert row["Model"] == "ColPali-v1.3" and row["Weights"] == "debug-random"
    for col in want_cols[2:-5]:
        assert np.isfinite(float(row[col])), col
        assert col.endswith("_std") or 0.0 <= float(row[col]) <= 100.0, col
    assert float(row["QPS"]) > 0
