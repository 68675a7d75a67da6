"""The MoE layers' spans and counters (``ops/moe.py``, ``models/deepseek.py``,
``utils/profiling.py``): the ``mme.moe.*`` ranges open only under a
profiler; ``moe.routed_rows`` counts tokens x top-k x MoE layers from
shapes, at the published depth and at the tests' size; the experts' loads,
counted on the device, sum to the routed rows; and ``grouped_mm`` is a key
of ``ops.launch_counts()``."""

from __future__ import annotations

import copy

import pytest
import torch

from multimodal_embedding_tpu_torch import ops
from multimodal_embedding_tpu_torch.models.colpali import ColPali, ColPaliConfig, debug_colpali_config
from multimodal_embedding_tpu_torch.models.deepseek import DeepseekConfig, DeepseekLM
from multimodal_embedding_tpu_torch.utils import graphs, profiling
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPANS = ("moe.route", "moe.experts", "moe.combine")


def _lm(cfg: DeepseekConfig, seed: int = 0) -> DeepseekLM:
    return DeepseekLM(cfg, gen=torch.Generator().manual_seed(seed), device="cpu", dtype=torch.float32)


def _debug_lm() -> DeepseekLM:
    return _lm(debug_colpali_config(decoder="deepseek").gemma)


def test_spans_open_only_under_a_profiler(monkeypatch):
    lm = _debug_lm()
    x = torch.randn(2, 5, lm.cfg.dim)

    def no_range(*a, **kw):
        raise AssertionError("a range was made with no profiler running")

    with monkeypatch.context() as m:
        m.setattr(profiling, "_RANGE", no_range)
        lm(x)
    assert lm.tally.n_spans == {} and lm.tally.seconds == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lm(x)
    names = [e.name for e in prof.events() if e.name.startswith("mme.moe.")]
    assert sorted(set(names)) == sorted(f"mme.{s}" for s in SPANS)
    assert lm.tally.n_spans == {s: lm.cfg.moe_layers for s in SPANS}
    assert all(lm.tally.seconds[s] > 0 for s in SPANS)


def test_routed_rows_at_the_published_depth():
    """27 layers, 64 experts, 6 a token, 2 shared, the first dense: tokens
    x 6 x 26 routed rows a forward (the widths cut to a test's size)."""
    cfg = DeepseekConfig(vocab_size=64, dim=32, layers=27, heads=2, mlp_dim=48, moe_dim=16, n_experts=64, top_k=6,
                         n_shared=2, kv_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_dim=8, rope_theta=800000.0)
    lm = _lm(cfg)
    lm(torch.randn(3, 7, cfg.dim))
    assert lm.tally.counts == {"moe.routed_rows": 3 * 7 * 6 * 26}
    loads = lm.take_expert_loads()
    assert loads.shape == (26, 64) and (loads.sum(axis=1) == 3 * 7 * 6).all()


@pytest.mark.parametrize("batch, length", [(1, 4), (2, 9)])
def test_routed_rows_and_loads_at_the_tests_size(batch, length):
    lm = _debug_lm()
    mask = torch.ones(batch, length, dtype=torch.int64)
    mask[-1, length // 2 :] = 0  # pad tokens are run and routed too
    for _ in range(2):
        lm(torch.randn(batch, length, lm.cfg.dim), attn_mask=mask)
    rows = 2 * batch * length * lm.cfg.top_k * lm.cfg.moe_layers
    assert lm.tally.counts == {"moe.routed_rows": rows}
    loads = lm.take_expert_loads()
    assert int(loads.sum()) == rows and (loads.sum(axis=1) == rows // lm.cfg.moe_layers).all()
    assert not lm.take_expert_loads().any()  # read once, then cleared


def test_loads_accumulate_under_the_engines_inference_mode():
    lm = _debug_lm()
    with torch.inference_mode():
        lm(torch.randn(1, 3, lm.cfg.dim))
    assert int(lm.take_expert_loads().sum()) == 3 * lm.cfg.top_k * lm.cfg.moe_layers


def test_route_sink_keeps_each_forwards_choices():
    base = debug_colpali_config(decoder="deepseek")
    model = ColPali(ColPaliConfig(vision=base.vision, gemma=base.gemma, embedding_dim=16), [1, 2, 3], seed=3,
                    device="cpu")
    lm = model.gemma
    lm.route_sink = []
    model.text_fwd(torch.tensor([[1, 5, 7, 0]]), torch.tensor([[1, 1, 1, 0]]))
    model.image_fwd(torch.randn(2, 28, 28, 3))
    assert [len(call) for call in lm.route_sink] == [lm.cfg.moe_layers] * 2
    assert lm.route_sink[0][0].shape == (4, lm.cfg.top_k) and lm.route_sink[1][0].shape == (2 * 7, lm.cfg.top_k)


def test_graphed_caption_batches_hand_over_their_routes_and_loads(monkeypatch):
    """On the card a caption batch of the DeepSeek ColPali replays a CUDA
    graph (``utils/graphs.py``) whose forward leaves no state behind: its
    routes and expert loads come back as outputs and ``text_fwd`` hands them
    to the sink and the counts. Here the graph is stood in for by the
    forward itself, which the capture records: the sink and the loads read
    as after a plain forward."""
    base = debug_colpali_config(decoder="deepseek")
    model = ColPali(ColPaliConfig(vision=base.vision, gemma=base.gemma, embedding_dim=16), [1, 2, 3], seed=3,
                    device="cpu")
    lm = model.gemma
    ids, mask = torch.tensor([[1, 5, 7, 9], [4, 2, 0, 0]]), torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0]])
    lm.route_sink = []
    want = model.text_fwd(ids, mask)
    want_routes, want_loads = lm.route_sink, lm.take_expert_loads()

    class Eager:
        calls = 0

        def __call__(self, fn, *args):
            Eager.calls += 1
            return fn(*args)

    monkeypatch.setattr(graphs, "applies", lambda x: True)
    model.text_graphs = Eager()
    lm.route_sink = []
    for _ in range(2):
        got = model.text_fwd(ids, mask)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert Eager.calls == 2 and lm.route_sink is not None and len(lm.route_sink) == 2
    for call in lm.route_sink:
        assert len(call) == lm.cfg.moe_layers
        for a, b in zip(call, want_routes[0]):
            assert torch.equal(a, b)
    assert (lm.take_expert_loads() == 2 * want_loads).all()
    lm.route_sink = None  # no sink: the routes are dropped, the loads still counted
    model.text_fwd(ids, mask)
    assert (lm.take_expert_loads() == want_loads).all()


def test_graphs_are_dropped_when_the_weights_move_or_the_model_is_copied():
    """A graph reads the tensors it was captured on: ``to``/``float`` drop a
    model's graphs, and a deep copy starts with none (a captured graph
    cannot be copied). Stood in for here by an entry no copy can take."""
    from multimodal_embedding_tpu_torch.models.towers import DualEncoder
    from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config

    base = debug_colpali_config(decoder="deepseek")
    colpali = ColPali(ColPaliConfig(vision=base.vision, gemma=base.gemma, embedding_dim=16), [1, 2, 3], seed=3,
                      device="cpu", dtype=torch.bfloat16)
    dual = DualEncoder(debug_dual_config("clip"), seed=0, device="cpu", dtype=torch.bfloat16)
    for model in (colpali, dual):
        model.text_graphs.graphs["captured"] = lambda: None
        twin = copy.deepcopy(model)
        assert twin.text_graphs.graphs == {} and "captured" in model.text_graphs.graphs
        model.float()
        assert model.text_graphs.graphs == {}
    twin = copy.deepcopy(colpali)
    assert twin.text_graphs.tallies[1] is twin.gemma.tally  # the copy counts into its own decoder's tally


def test_graphs_apply_only_to_card_tensors_without_autograd():
    x = torch.zeros(2, 3, dtype=torch.int64)
    with torch.inference_mode():
        assert not graphs.applies(x)  # CPU tensors run the forward as it is


def test_grouped_launches_are_a_launch_count(monkeypatch):
    monkeypatch.setattr(profiling.KERNELS, "counts", {})
    assert "grouped_mm" in ops.LAUNCH_KEYS and ops.launch_counts()["grouped_mm"] == 0
    lm = _debug_lm()
    lm(torch.randn(1, 3, lm.cfg.dim))
    assert ops.launch_counts()["grouped_mm"] == 0  # CPU tensors take the plain version
