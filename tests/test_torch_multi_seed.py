"""The port's V28 multi-seed CLI against the JAX package's, on the CPU.

``main`` at debug size (16 images a run from a 32-image pool, 2 runs, 4
synthetic Winoground samples, ``--mrr``) in both packages, the port's model
carrying the JAX package's debug OpenAI-CLIP-L weights (``params_from_jax``),
so both encode the same embeddings up to f32 rounding (1e-5): the CSV
columns are the JAX package's, in its order, and every cell but the timing
ones (Time, QPS, Img/s) is equal as written ("mean ± std" at one decimal).
The port's encode-once mode also equals its ``--per-run-encode`` mode, for
OpenAI-CLIP-L and ColPali-v1.3 (COMPAT #13), and every R@K and Winoground
percentage of ColPali is finite and in [0, 100].
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_embedding_tpu.cli.multi_seed import main as jax_v28_main
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu_torch.cli import multi_seed
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ["--dataset", "synthetic", "--debug-models", "--sample-size", "16", "--runs", "2",
        "--winoground-samples", "4", "--mrr", "--batch-size", "8"]
TIMING = {"Time", "QPS", "Img/s"}


def test_main_matches_jax_given_the_same_weights(tmp_path, monkeypatch):
    jax_out, port_out = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_v28_main([*ARGS, "--models", "OpenAI-CLIP-L", "--output", str(jax_out)]) == 0

    def jax_weights(info, *, debug, arch, seed, device, **kw):
        assert debug and not arch
        model = load_debug_model(info, seed=seed, device=device)
        params = jax.tree.map(np.asarray, jax_load_debug_model(info, seed=seed).params)
        model.model.load_state_dict(params_from_jax(params, device=device))
        return model

    monkeypatch.setattr(multi_seed, "load_model_for", jax_weights)
    assert multi_seed.main([*ARGS, "--models", "OpenAI-CLIP-L", "--device", "cpu", "--output", str(port_out)]) == 0
    want, got = pd.read_csv(jax_out), pd.read_csv(port_out)
    assert list(got.columns) == list(want.columns)
    assert {"Wino Text", "T2I_R@1", "I2T_R@10", "T2I_MRR", "I2T_MRR", "I2T_Sym_R@5", "Img/s"} <= set(got.columns)
    for col in got.columns:
        if col not in TIMING:
            assert list(got[col]) == list(want[col]), col
    assert "±" in str(got["QPS"][0])


def test_encode_once_equals_per_run_encode(tmp_path):
    args = [*ARGS, "--models", "OpenAI-CLIP-L,ColPali-v1.3", "--device", "cpu"]
    once, rerun = tmp_path / "once.csv", tmp_path / "rerun.csv"
    assert multi_seed.main([*args, "--output", str(once)]) == 0
    assert multi_seed.main([*args, "--per-run-encode", "--output", str(rerun)]) == 0
    a, b = pd.read_csv(once), pd.read_csv(rerun)
    assert list(a.columns) == list(b.columns) and list(a["Model"]) == ["OpenAI-CLIP-L", "ColPali-v1.3"]
    for col in a.columns:
        if col not in TIMING:
            assert list(a[col]) == list(b[col]), col
    colpali = a.iloc[1]
    for col in [c for c in a.columns if "R@" in c] + ["Wino Text", "Wino Image", "Wino Group"]:
        val = float(str(colpali[col]).split("±")[0])
        assert np.isfinite(val) and 0.0 <= val <= 100.0, (col, colpali[col])


def test_main_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        multi_seed.main([*ARGS, "--models", "OpenAI-CLIP-L", "--output", str(tmp_path / "x.csv")])
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "x.csv").exists()
