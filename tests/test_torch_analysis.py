"""The port's statistics and report layer against the JAX package's, on the CPU.

- ``stats/ci.py:permutation_test``: on JAX's own permutations, replayed as
  an index matrix, the p-value equals JAX's exactly (tolerance 0: the same
  shuffles, the same f32 comparisons; the inputs are continuous, so no
  statistic sits within rounding of the observed one). The test first
  checks that ``combined[jax.random.permutation(key, n)]`` is the array
  ``jax.random.permutation(key, combined)`` gives. With the port's own
  generator the p-value lies within 3 sigma of JAX's (sigma: the binomial
  spread of a share of 10,000 shuffles).
- ``analysis/report.py`` (a copy whose permutation tests run in the port):
  on a CSV and ``.bootstrap.npz`` sidecar written by the port's CLI, and the
  same permutations, the port's report equals the JAX report on the same
  files, line for line, but for its title and hardware line, which name
  PyTorch/CUDA. The bootstrap metrics there are multiples of 100/16, exact
  in f32, so every order of summation gives the same means.
- The copied host modules (``cli/analyze.py``, ``analysis/plots.py``,
  ``cli/merge_results.py``, ``cli/inspect_data.py``) behave as the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_embedding_tpu.analysis import report as jreport
from multimodal_embedding_tpu.cli.merge_results import merge_csvs as jmerge
from multimodal_embedding_tpu.stats.ci import permutation_test as jax_permutation_test
from multimodal_embedding_tpu_torch.analysis import report as treport
from multimodal_embedding_tpu_torch.cli import analyze as tanalyze
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.cli.merge_results import merge_csvs as tmerge
from multimodal_embedding_tpu_torch.stats import ci as tci
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_PERM = 10_000


def jax_permutations(n: int) -> np.ndarray:
    """The index matrix of JAX's permutation_test(seed=0) shuffles."""
    keys = jax.random.split(jax.random.key(0), N_PERM)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


def _samples(shift: float, n1: int = 24, n2: int = 20):
    rng = np.random.default_rng(7)
    return rng.standard_normal(n1).astype(np.float32), (rng.standard_normal(n2) + shift).astype(np.float32)


def test_permutation_indices_reproduce_jax_shuffles():
    x = jnp.asarray(np.random.default_rng(1).standard_normal(44).astype(np.float32))
    keys = jax.random.split(jax.random.key(0), 64)
    idx = jax.vmap(lambda k: jax.random.permutation(k, 44))(keys)
    np.testing.assert_array_equal(np.asarray(x[idx]), np.asarray(jax.vmap(lambda k: jax.random.permutation(k, x))(keys)))


@pytest.mark.parametrize("shift", [0.0, 0.5, 1.0])
def test_permutation_test_replays_jax_exactly(shift):
    a, b = _samples(shift)
    want = jax_permutation_test(a, b)
    got = tci.permutation_test(a, b, idx=jax_permutations(a.size + b.size), device="cpu")
    assert got == want
    own = tci.permutation_test(a, b, device="cpu")
    sigma = np.sqrt(max(want * (1 - want), 1.0 / N_PERM) / N_PERM)
    assert abs(own - want) <= 3 * sigma, (own, want)
    assert tci.permutation_test(a, b, device="cpu") == own  # seeded


def test_permutation_test_checks_replayed_indices():
    a, b = _samples(0.0)
    with pytest.raises(ValueError):
        tci.permutation_test(a, b, n_permutations=4, idx=np.zeros((4, 3), np.int64), device="cpu")


def test_analyze_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tanalyze.main(["--input", str(tmp_path / "x.csv"), "--output", str(tmp_path / "r.md")])
    assert exc.value.code not in (0, None)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("res") / "results.csv"
    assert tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models",
                      "--models", "OpenAI-CLIP-L,SigLIP-400M", "--sample-size", "16",
                      "--bootstrap-iterations", "10", "--batch-size", "8", "--output", str(out)]) == 0
    return out


def _port_lines_as_jax(text: str) -> list[str]:
    return (text.replace("# Statistical Analysis Report - COCO Benchmark V29 (PyTorch/CUDA)",
                         "# Statistical Analysis Report - COCO Benchmark V29 (TPU)")
            .replace("- NVIDIA GPU (PyTorch/CUDA), bootstrap runs fully on device",
                     "- TPU (JAX/XLA/Pallas), bootstrap runs fully on device").splitlines())


def test_report_equals_jax_on_the_port_files(port_results, tmp_path, monkeypatch):
    df = pd.read_csv(port_results)
    boot = treport.load_bootstrap_sidecar(port_results)
    assert sorted(boot) == ["OpenAI-CLIP-L", "SigLIP-400M"]
    want = jreport.generate_report(df, str(tmp_path / "jax.md"), bootstrap=jreport.load_bootstrap_sidecar(port_results))
    idx = jax_permutations(2 * 10)
    replay = tci.permutation_test
    monkeypatch.setattr(tci, "permutation_test", lambda a, b, **kw: replay(a, b, idx=idx, **kw))
    got = treport.generate_report(df, str(tmp_path / "port.md"), bootstrap=boot, device="cpu")
    assert "permutation test on raw bootstrap samples" in got
    assert _port_lines_as_jax(got) == want.splitlines()
    assert (tmp_path / "port.md").read_text() == got


def test_analyze_cli_and_plots(port_results, tmp_path):
    report = tmp_path / "report.md"
    assert tanalyze.main(["--input", str(port_results), "--output", str(report), "--plots", "--device", "cpu"]) == 0
    text = report.read_text()
    for part in ("## Text-to-Image Retrieval", "permutation test on raw bootstrap samples", "Efficiency Score",
                 "Per-Category Performance", "OpenAI-CLIP-L", "SigLIP-400M"):
        assert part in text
    assert report.with_suffix(".pareto.png").stat().st_size > 1000
    assert report.with_suffix(".categories.png").stat().st_size > 1000
    bare = tmp_path / "no_sidecar.csv"
    bare.write_text(port_results.read_text())
    assert tanalyze.main(["--input", str(bare), "--output", str(tmp_path / "r2.md"), "--device", "cpu"]) == 0
    assert "CI-overlap approximation" in (tmp_path / "r2.md").read_text()


def test_merge_results_copy_matches_jax(tmp_path):
    from multimodal_embedding_tpu_torch.cli.merge_results import main as merge_main

    a, b, out = tmp_path / "a.csv", tmp_path / "b.csv", tmp_path / "m.csv"
    pd.DataFrame([{"Model": "A", "T2I_R@1_mean": 1.0, "Weights": "arch-random"},
                  {"Model": "B", "T2I_R@1_mean": 2.0}]).to_csv(a, index=False)
    pd.DataFrame([{"Model": "B", "T2I_R@1_mean": 9.0}, {"Model": "C", "T2I_R@1_mean": 3.0}]).to_csv(b, index=False)
    assert merge_main([str(a), str(b), "--output", str(out)]) == 0
    got = pd.read_csv(out)
    assert got.equals(jmerge([str(a), str(b)]).pipe(lambda d: d.to_csv(tmp_path / "j.csv", index=False) or
                                                     pd.read_csv(tmp_path / "j.csv")))
    assert list(got["Model"]) == ["A", "B", "C"] and list(got["Weights"]) == ["arch-random", "unknown", "unknown"]
    assert tmerge([str(a)]).equals(jmerge([str(a)]))


def test_inspect_data_copy_parses_karpathy_splits_as_jax(tmp_path):
    import json

    from multimodal_embedding_tpu.cli import inspect_data as jinspect
    from multimodal_embedding_tpu_torch.cli import inspect_data as tinspect

    split = tmp_path / "data" / "dataset_coco.json"
    split.parent.mkdir()
    split.write_text(json.dumps({"images": [
        {"split": "train", "imgid": 3}, {"split": "restval", "cocoid": 9}, {"split": "val", "filename": "x7.jpg"},
        {"split": "test", "imgid": 0}, {"split": "test", "imgid": 5},
    ]}))
    assert tinspect.find_karpathy_json([str(tmp_path)]) == jinspect.find_karpathy_json([str(tmp_path)]) == split
    got = tinspect.main(["karpathy", "--json", str(split), "--out-dir", str(tmp_path / "port"), "--prefix", "coco"])
    want = jinspect.main(["karpathy", "--json", str(split), "--out-dir", str(tmp_path / "jax"), "--prefix", "coco"])
    assert got == want == 0
    for name in ("train", "val", "test"):
        f = f"coco_{name}_ids.txt"
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
