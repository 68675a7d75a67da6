"""The text towers' CUDA graphs (``utils/graphs.py``) on the card: the
DeepSeek ColPali's caption batches (Kimi-VL-A3B's widths, 3 of its 27
layers) and CLIP-L's text tower, each replay against the plain forward.

Marked ``cuda``: each test skips where there is no CUDA device (decided in a
fixture, at run time). Run them on the card with

    python -m pytest --noconftest tests/test_torch_graphs_cuda.py -q

- A replay computes what the eager forward computes, bit for bit (the same
  kernels on the same shapes), for new inputs of a captured shape, and a
  new shape is captured beside the old.
- The DeepSeek batches hand each forward's chosen experts to the route sink
  and add its expert loads, as the eager forward does, and a replay adds
  the eager forward's launch and ``moe.routed_rows`` counts.
- A replay makes no host sync (``torch.cuda.set_sync_debug_mode`` "error").
"""

import dataclasses

import pytest
import torch

from multimodal_embedding_tpu_torch.models.arch import full_arch_config, full_colpali_deepseek_config
from multimodal_embedding_tpu_torch.models.colpali import ColPali
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.ops import launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _caption_batch(dev, vocab, b, t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(1, vocab, (b, t), generator=g, device=dev)
    mask = torch.ones(b, t, dtype=torch.int64, device=dev)
    mask[b // 2 :, t - 5 :] = 0  # right-padded captions, as a sweep pads to its longest
    return ids * mask, mask


@pytest.fixture
def colpali(dev):
    cfg = full_colpali_deepseek_config()
    cfg = dataclasses.replace(cfg, gemma=dataclasses.replace(cfg.gemma, layers=3))
    return ColPali(cfg, [2, 10, 11, 12, 13, 14], seed=0, device=dev, dtype=torch.bfloat16)


def test_deepseek_caption_batches_replay_the_eager_forward(dev, colpali):
    lm = colpali.gemma
    vocab = lm.cfg.vocab_size
    with torch.inference_mode():
        for shape_seed, (b, t) in enumerate([(32, 24), (128, 21)]):
            for call in range(3):  # the first captures, the next two replay
                ids, mask = _caption_batch(dev, vocab, b, t, 10 * shape_seed + call)
                lm.route_sink = []
                lm.take_expert_loads()
                before = launch_counts(), dict(lm.tally.counts)
                want = colpali._text(ids, mask)
                plain = launch_counts(), dict(lm.tally.counts)
                want_routes, want_loads = lm.route_sink[0], lm.take_expert_loads()
                lm.route_sink = []
                got = colpali.text_fwd(ids, mask)
                after = launch_counts(), dict(lm.tally.counts)
                assert torch.equal(got, want), (b, t, call)
                assert len(lm.route_sink) == 1 and len(lm.route_sink[0]) == lm.cfg.moe_layers
                assert all(torch.equal(x, y) for x, y in zip(lm.route_sink[0], want_routes))
                assert (lm.take_expert_loads() == want_loads).all()
                for c0, c1, c2 in zip(before, plain, after):
                    assert {k: c1.get(k, 0) - c0.get(k, 0) for k in c1} == {k: c2.get(k, 0) - c1.get(k, 0) for k in c1}
        assert len(colpali.text_graphs.graphs) == 2


def test_deepseek_replay_makes_no_host_sync(dev, colpali):
    ids, mask = _caption_batch(dev, colpali.gemma.cfg.vocab_size, 32, 24, 0)
    with torch.inference_mode():
        colpali.text_fwd(ids, mask)  # the capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = colpali.text_fwd(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all())


def test_clip_text_batches_replay_the_eager_forward(dev):
    model = DualEncoder(full_arch_config("OpenAI-CLIP-L"), seed=0, device=dev, dtype=torch.bfloat16)
    vocab = model.cfg.text.vocab_size
    with torch.inference_mode():
        for b in (128, 68):
            for call in range(3):
                ids, mask = _caption_batch(dev, vocab, b, 77, 100 * b + call)
                before = launch_counts()
                want = model.text(ids, mask)
                plain = launch_counts()
                got = model.encode_text(ids, mask)
                after = launch_counts()
                assert torch.equal(got, want), (b, call)
                assert {k: plain[k] - before[k] for k in plain} == {k: after[k] - plain[k] for k in plain}
        assert len(model.text_graphs.graphs) == 2
