"""The port's CLI on 2 gloo ranks on the CPU (``torch_parallel_world``).

One world of 2 ranks runs ``cli.main`` with the debug models three times:
plain data parallelism (OpenAI-CLIP-L), ``--tensor-parallel 2``
(OpenAI-CLIP-L) and ``--sequence-parallel 2`` (ColPali-v1.3). Each rank has
its own ``PYTHONHASHSEED``, so the debug tokenizer gives each rank other ids
for the same caption. Rank 0 then runs both models alone in the same process
(the same hash salt), after the group is gone. Checked: every run exits 0,
only rank 0 writes (one CSV a run, its bootstrap sidecar and the log), every
rank encoded rank 0's token ids, the data-parallel row's metrics equal the
run alone's, and the tensor- and sequence-parallel rows are within one query
of 16 (100/16 points) of it: their f32 sums run in another order, so a pair of
scores closer than that rounding may order differently.
"""

import numpy as np
import pandas as pd
import pytest

from multimodal_embedding_tpu_torch.cli import main as tcli
from tests.torch_parallel_world import run_world

N = 16
METRICS = [f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
           for s in ("mean", "lower", "upper", "std")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli_world")
    return work, run_world("cli", 2, work, {})


def test_every_run_exits_zero(world):
    _, outs = world
    for o in outs:
        assert (o["rc_dp"], o["rc_tp"], o["rc_sp"]) == (0, 0, 0)
    assert outs[0]["rc_alone"] == 0


def test_only_rank0_writes(world):
    work, outs = world
    assert sorted(outs[0]["to_csv"]) == ["alone.csv", "alone.csv", "dp.csv", "sp.csv", "tp.csv"]
    assert outs[1]["to_csv"] == [] and outs[1]["savez"] == []
    assert outs[0]["log_written"] and all(p.endswith(".bootstrap.npz") for p in outs[0]["savez"])
    for tag, model in (("dp", "OpenAI-CLIP-L"), ("tp", "OpenAI-CLIP-L"), ("sp", "ColPali-v1.3")):
        df = pd.read_csv(work / f"{tag}.csv")
        assert list(df["Model"]) == [model]
        assert df[METRICS].apply(np.isfinite).all().all()


def test_every_rank_encodes_rank0_token_ids(world):
    _, outs = world
    shared = [o["shared"] for o in outs]
    assert len(shared[0]) == len(shared[1]) > 0
    salted_apart = 0
    for (mine0, got0), (mine1, got1) in zip(*shared):
        np.testing.assert_array_equal(got0, mine0)  # rank 0 keeps its own ids
        np.testing.assert_array_equal(got1, got0)  # rank 1 takes them
        salted_apart += not np.array_equal(mine1, mine0)
    assert salted_apart > 0  # rank 1's own tokenization differed: the broadcast mattered


def _rows(work):
    alone = pd.read_csv(work / "alone.csv").set_index("Model")
    return {tag: pd.read_csv(work / f"{tag}.csv").set_index("Model") for tag in ("dp", "tp", "sp")}, alone


def test_data_parallel_row_equals_one_rank(world):
    work, _ = world
    rows, alone = _rows(work)
    np.testing.assert_array_equal(rows["dp"].loc["OpenAI-CLIP-L", METRICS].to_numpy(float),
                                  alone.loc["OpenAI-CLIP-L", METRICS].to_numpy(float))


@pytest.mark.parametrize("tag,model", [("tp", "OpenAI-CLIP-L"), ("sp", "ColPali-v1.3")])
def test_model_parallel_rows_match_one_rank(world, tag, model):
    work, _ = world
    rows, alone = _rows(work)
    got = rows[tag].loc[model, [m for m in METRICS if m.endswith("_mean")]].to_numpy(float)
    want = alone.loc[model, [m for m in METRICS if m.endswith("_mean")]].to_numpy(float)
    np.testing.assert_allclose(got, want, atol=100.0 / N + 1e-9, rtol=0)


def test_cli_refuses_tensor_and_sequence_parallel_together(tmp_path):
    with pytest.raises(SystemExit, match="pick one"):
        tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--tensor-parallel", "2",
                   "--sequence-parallel", "2", "--output", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


@pytest.mark.parametrize("name,ok", [("cuda", True), ("cuda:1", True), ("cpu", True), ("gpu", False),
                                     ("cuda:x", False)])
def test_device_flag_takes_cuda_n(name, ok):
    if ok:
        assert tcli.parse_args(["--device", name]).device == name
    else:
        with pytest.raises(SystemExit):
            tcli.parse_args(["--device", name])
