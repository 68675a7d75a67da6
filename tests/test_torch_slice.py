"""The port's whole slice against the JAX package's, on the CPU.

The same synthetic records and the same debug OpenAI-CLIP-L weights (drawn
by the JAX package, carried by ``params_from_jax``) go through both
packages' encode -> score -> bootstrap -> CSV row. L2-normalized embeddings
and both score matrices agree to 1e-4 (f32 sums in another order); the CSV
columns are identical and in the same order; with the JAX package's
bootstrap samples and CI resamples replayed, each metric agrees to within
one query of N (a score pair closer than the 1e-4 tolerance may order
differently in the two packages).

Also here: the port imports nothing of JAX or the JAX package (its
``parallel/`` package included), its copies of the JAX-free host modules
behave the same, and its CLI refuses to run on the CPU unless asked to and,
in a world of one rank, refuses a model axis of 2 with the JAX CLI's words.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.cli import main as jcli
from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
from multimodal_embedding_tpu.models.encode import stage_images as jax_stage_images
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.parallel.mesh import get_mesh
from multimodal_embedding_tpu.stats.bootstrap import bootstrap_benchmark as jax_bootstrap
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model

ROOT = Path(__file__).resolve().parent.parent
N_IMAGES, ITERS, BATCH, SEED = 32, 20, 16, 42


@pytest.fixture(scope="module")
def slice_pair():
    from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset

    records = synthetic_retrieval_dataset(N_IMAGES, seed=SEED)
    (jinfo,) = jax_models("OpenAI-CLIP-L", BATCH)
    (tinfo,) = get_models_to_test("OpenAI-CLIP-L", BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    return records, jmodel, tmodel


def test_embeddings_and_scores_match_jax(slice_pair):
    records, jmodel, tmodel = slice_pair
    mesh = get_mesh()
    jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
    tengine = EncodingEngine(tmodel, BATCH, device="cpu")
    jcache = jax_stage_images([r["image"] for r in records], mesh, BATCH)
    tcache = stage_images([r["image"] for r in records], BATCH, "cpu")
    np.testing.assert_allclose(tengine.encode_images_cached(tcache).embeddings.numpy(),
                               np.asarray(jengine.encode_images_cached(jcache).embeddings), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tengine.encode_images([r["image"] for r in records[:5]]).embeddings.numpy(),
                               np.asarray(jengine.encode_images([r["image"] for r in records[:5]]).embeddings),
                               atol=1e-4, rtol=0)
    caps = [c for r in records for c in r["captions"]]
    np.testing.assert_allclose(tengine.encode_texts(caps).embeddings.numpy(),
                               np.asarray(jengine.encode_texts(caps).embeddings), atol=1e-4, rtol=0)
    js_t2i, js_i2t, _ = jcli.compute_score_matrices(jmodel, jengine, records, cache=jcache, mesh=mesh)
    ts_t2i, ts_i2t, _ = tcli.compute_score_matrices(tmodel, tengine, records, cache=tcache)
    np.testing.assert_allclose(ts_t2i.numpy(), np.asarray(js_t2i), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts_i2t.numpy(), np.asarray(js_i2t), atol=1e-4, rtol=0)


def test_csv_row_matches_jax(slice_pair):
    records, jmodel, tmodel = slice_pair
    mesh = get_mesh()
    want = jcli.run_bootstrap_benchmark(jmodel, records, ITERS, mesh, batch_size=BATCH, seed=SEED,
                                        transport="device")
    # the JAX run's samples: its bootstrap draws them from the seed alone
    jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
    s_t2i, s_i2t, _ = jcli.compute_score_matrices(jmodel, jengine, records, mesh=mesh)
    sample_idx = jax_bootstrap(s_t2i, s_i2t, ITERS, seed=SEED).sample_idx
    ci_idx = np.asarray(jax.random.randint(jax.random.key(0), (10_000, ITERS), 0, ITERS))
    got = tcli.run_bootstrap_benchmark(tmodel, records, ITERS, device="cpu", batch_size=BATCH, seed=SEED,
                                       cache=stage_images([r["image"] for r in records], BATCH, "cpu"),
                                       sample_idx=sample_idx, ci_idx=ci_idx)
    assert list(got) == list(want)
    one_query = 100.0 / N_IMAGES
    for key, val in want.items():
        if key.endswith(("_mean", "_lower", "_upper")):
            assert abs(got[key] - val) <= one_query + 1e-4, key
    assert got["Weights"] == want["Weights"] == "debug-random"
    assert set(json.loads(got["_failure_analysis"])) == set(json.loads(want["_failure_analysis"]))


def test_port_cli_writes_the_reference_schema(tmp_path):
    out = tmp_path / "port.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "OpenAI-CLIP-L",
                    "--sample-size", "16", "--bootstrap-iterations", "8", "--batch-size", "8",
                    "--encode-passes", "2", "--output", str(out), "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0
    assert (tmp_path / "prof" / "OpenAI-CLIP-L" / "ops.txt").exists()
    import pandas as pd

    df = pd.read_csv(out)
    want_cols = ["Model", "Weights"] + [
        f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
        for s in ("mean", "lower", "upper", "std")
    ] + ["Time", "QPS", "Encoding_Time", "Img_per_sec", "_failure_analysis"]
    assert list(df.columns) == want_cols
    assert float(df["QPS"][0]) > 0
    assert (tmp_path / "port.csv.bootstrap.npz").exists()


def test_cli_refuses_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.csv"
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--dataset", "synthetic", "--debug-models", "--sample-size", "4", "--output", str(out)])
    assert exc.value.code not in (0, None)
    assert not out.exists()


@pytest.mark.parametrize("flags", [["--tensor-parallel", "2"], ["--sequence-parallel", "2"]])
def test_cli_rejects_unported_flags(tmp_path, flags):
    """Both flags are ported; one process is a world of one rank, which a
    model axis of 2 does not fit (the JAX CLI's ``get_mesh`` error)."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tcli.main(["--device", "cpu", "--dataset", "synthetic", "--sample-size", "4",
                   "--output", str(tmp_path / "x.csv"), "--debug-models", *flags])
    assert not (tmp_path / "x.csv").exists()


@pytest.mark.parametrize("flags", [
    ["--layer-impl", "fused"], ["--layer-impl", "xla"], ["--native-cache-dir", "cache"],
    ["--attention-impl", "flash"], ["--transport", "host"], ["--streaming-encode"],
    ["--score-cache-dir", "scores"], ["--no-overlap-staging"],
])
def test_cli_accepts_ported_flags(flags):
    tcli.check_parallel_flags(tcli.parse_args(["--device", "cpu", "--debug-models", *flags]))


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_no_jax():
    files = sorted((ROOT / "multimodal_embedding_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    parallel = {f.name for f in files if f.parent.name == "parallel"}
    assert {"mesh.py", "batched.py", "tp.py", "sp.py"} <= parallel, parallel
    bad = {
        str(f.relative_to(ROOT)): m
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "multimodal_embedding_tpu")
    }
    assert not bad, bad


def test_host_module_copies_behave_the_same():
    from multimodal_embedding_tpu.analysis.failure import aggregate_failure_analysis as jfa
    from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset as jsyn
    from multimodal_embedding_tpu_torch.analysis.failure import aggregate_failure_analysis as tfa
    from multimodal_embedding_tpu_torch.data.synthetic import synthetic_retrieval_dataset as tsyn

    a, b = jsyn(6, seed=3), tsyn(6, seed=3)
    for ra, rb in zip(a, b):
        assert ra["captions"] == rb["captions"] and np.array_equal(ra["image"], rb["image"])
    rng = np.random.default_rng(0)
    correct = rng.random((5, 6)) < 0.5
    idx = rng.integers(0, 6, (5, 6))
    caps = [r["captions"][0] for r in a]
    assert tfa(correct, idx, caps) == jfa(correct, idx, caps)

