"""The port's score cache (``--score-cache-dir``), on the CPU.

Held to the JAX package's ``stats/score_cache.py``: the same file layout
(``scores_<model>_<dataset>_<numerics>.npz`` with ``s_t2i``, ``s_i2t`` and
``encoding_time``), a round trip that is exact (tolerance 0), a miss when
the numerics differ, and a numerics key that names this package, so neither
package reads the other's files. The CLI's second run reads the matrices
and encodes nothing, and its CSV metrics equal the first run's (tolerance 0:
the same scores, the same bootstrap draws).
"""

import numpy as np
import pandas as pd

from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset
from multimodal_embedding_tpu.stats import score_cache as jcache
from multimodal_embedding_tpu_torch import runtime
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.stats import score_cache
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RECORDS = synthetic_retrieval_dataset(6, seed=0)


def _matrices():
    rng = np.random.default_rng(0)
    return rng.standard_normal((6, 6)).astype(np.float32), rng.standard_normal((6, 30)).astype(np.float32)


def test_round_trip_is_exact(tmp_path):
    s_t2i, s_i2t = _matrices()
    score_cache.save_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, s_t2i, s_i2t, 1.25, device="cpu")
    (path,) = tmp_path.glob("scores_*.npz")
    assert path.name == (f"scores_OpenAI-CLIP-L_{score_cache.dataset_fingerprint(RECORDS)}_"
                         f"{score_cache.numerics_fingerprint(device='cpu')}.npz")
    with np.load(path) as data:
        assert sorted(data.files) == ["encoding_time", "s_i2t", "s_t2i"]
    got = score_cache.load_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, device="cpu")
    np.testing.assert_array_equal(got[0], s_t2i)
    np.testing.assert_array_equal(got[1], s_i2t)
    assert got[2] == 1.25


def test_dataset_fingerprint_is_the_jax_packages():
    assert score_cache.dataset_fingerprint(RECORDS) == jcache.dataset_fingerprint(RECORDS)
    assert score_cache.dataset_fingerprint(RECORDS[:5]) != score_cache.dataset_fingerprint(RECORDS)


def test_other_numerics_miss(tmp_path):
    s_t2i, s_i2t = _matrices()
    score_cache.save_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, s_t2i, s_i2t, 1.0, device="cpu")

    def load(**kw):
        return score_cache.load_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, device="cpu", **kw)

    assert load() is not None
    assert load(preprocess_impl="pallas") is None
    assert score_cache.load_scores(str(tmp_path), "SigLIP-400M", RECORDS, device="cpu") is None
    assert score_cache.load_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS[:5], device="cpu") is None
    for impl in ("flash", "xla_bf16", "pallas"):
        with runtime.using(attention=impl):
            assert load() is None, impl
    with runtime.using(layer="fused"):
        assert load() is None


def test_neither_package_reads_the_others_files(tmp_path):
    s_t2i, s_i2t = _matrices()
    key = score_cache.numerics_fingerprint(device="cpu")
    assert key == "torch-cpu-xla-xla-xla-xla" and key != jcache.numerics_fingerprint()
    jcache.save_scores(str(tmp_path / "jax"), "OpenAI-CLIP-L", RECORDS, s_t2i, s_i2t, 1.0)
    assert score_cache.load_scores(str(tmp_path / "jax"), "OpenAI-CLIP-L", RECORDS, device="cpu") is None
    score_cache.save_scores(str(tmp_path / "port"), "OpenAI-CLIP-L", RECORDS, s_t2i, s_i2t, 1.0, device="cpu")
    assert jcache.load_scores(str(tmp_path / "port"), "OpenAI-CLIP-L", RECORDS) is None


def test_unreadable_file_re_encodes(tmp_path):
    s_t2i, s_i2t = _matrices()
    score_cache.save_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, s_t2i, s_i2t, 1.0, device="cpu")
    (path,) = tmp_path.glob("scores_*.npz")
    path.write_bytes(b"not a zip file")
    assert score_cache.load_scores(str(tmp_path), "OpenAI-CLIP-L", RECORDS, device="cpu") is None


def test_cli_rerun_reads_the_scores_and_encodes_nothing(tmp_path, monkeypatch):
    common = ["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "OpenAI-CLIP-L",
              "--sample-size", "16", "--bootstrap-iterations", "6", "--batch-size", "8",
              "--score-cache-dir", str(tmp_path / "scores")]
    assert tcli.main([*common, "--output", str(tmp_path / "r1.csv")]) == 0
    assert len(list((tmp_path / "scores").glob("scores_*.npz"))) == 1

    def no_encode(*a, **kw):
        raise AssertionError("the rerun built an encoding engine")

    monkeypatch.setattr(tcli, "EncodingEngine", no_encode)
    assert tcli.main([*common, "--output", str(tmp_path / "r2.csv")]) == 0
    df1, df2 = pd.read_csv(tmp_path / "r1.csv"), pd.read_csv(tmp_path / "r2.csv")
    cols = [c for c in df1.columns if "_R@" in c] + ["QPS", "Encoding_Time", "Img_per_sec"]
    assert df1[cols].equals(df2[cols])
