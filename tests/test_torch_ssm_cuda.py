"""Granite-4.0-H-Small's hybrid decoder on the card (``models/granite.py``,
``ops/ssm.py``, ``csrc/ssm.cu``), at its published widths.

Marked ``cuda``: each test skips where there is no CUDA device (decided in a
fixture, at run time). Run them on the card with

    python -m pytest --noconftest tests/test_torch_ssm_cuda.py -q

- The scan kernel (the recurrence token by token, the state in f32
  registers) against its plain version (``ops/ssm.py:scan_plain``, the
  chunked form in f32) on the same inputs, at a page batch of the cell (8 x
  1030 tokens, 128 heads of 64, state 128) and at ragged lengths: within one
  bf16 step of the plain output (both round an f32 result once; the two sum
  the state in other orders, and the plain form takes each decay as the
  difference of two f32 cumulative sums of up to a few hundred, about 3e-5
  off) plus 1e-4 of the output's largest magnitude, and within 1e-4 of it in
  f32; counted once a launch as ``ssm_scan``.
- No host sync inside a layer: a Mamba-2 layer and an attention layer, each
  with its MoE block, run under ``torch.cuda.set_sync_debug_mode("error")``.
- A ColPali-Granite-4.0-H-Small forward launches 36 ``ssm_scan``, 80
  ``moe_swiglu`` (the routed and the shared expert a layer) and 40
  ``moe_combine``; a caption batch's CUDA-graph replay equals its eager
  forward bit for bit and adds the same counts.
"""

import pytest
import torch

from multimodal_embedding_tpu_torch.models.arch import full_colpali_granite_config
from multimodal_embedding_tpu_torch.models.colpali import ColPali
from multimodal_embedding_tpu_torch.models.granite import GraniteLayer
from multimodal_embedding_tpu_torch.ops import launch_counts
from multimodal_embedding_tpu_torch.ops import ssm
from multimodal_embedding_tpu_torch.utils.profiling import Tally

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, t, h=128, p=64, n=128, dtype=torch.bfloat16, seed=0):
    """Inputs at the scale a Mamba-2 layer of the cell feeds its scan: x, B
    and C SiLU outputs of about 0.4, dt from the initialiser's range, A in
    [-16, -1], D ones; x, B and C views into one [B, T, H*P + 2N] tensor, as
    the conv's output holds them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.nn.functional.silu(torch.randn(b, t, h * p + 2 * n, generator=g, device=dev)).to(dtype)
    x, bm, cm = xbc.split([h * p, n, n], dim=-1)
    raw = torch.randn(b, t, h, generator=g, device=dev) * 1.28 + torch.rand(h, generator=g, device=dev) * 4.6 - 6.9
    dt = torch.nn.functional.softplus(raw).to(dtype)
    a = -(1 + 15 * torch.rand(h, generator=g, device=dev))
    return x.unflatten(-1, (h, p)), dt, a, bm, cm, torch.ones(h, device=dev, dtype=dtype)


@pytest.mark.parametrize("b, t, h, p, n", [(8, 1030, 128, 64, 128), (3, 37, 128, 64, 128), (2, 1, 16, 8, 16),
                                           (1, 300, 4, 64, 64), (2, 19, 6, 32, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_the_plain_scan(dev, b, t, h, p, n, dtype):
    args = _inputs(dev, b, t, h, p, n, dtype)
    before = launch_counts()["ssm_scan"]
    with torch.inference_mode():
        got = ssm.scan(*args, chunk=256)
        want = ssm.scan_plain(*args, chunk=256)
    assert launch_counts()["ssm_scan"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if dtype == torch.bfloat16:
        step = torch.finfo(torch.bfloat16).eps * w.abs()  # one bf16 step of the plain output
        assert bool(((g - w).abs() <= step + 1e-4 * top).all())
    else:
        assert float((g - w).abs().max()) <= 1e-4 * top


def _layer(dev, index):
    cfg = full_colpali_granite_config().gemma
    layer = GraniteLayer(cfg, index, gen=torch.Generator(device=dev).manual_seed(index), device=dev,
                         dtype=torch.bfloat16)
    layer.tally, layer.loads = Tally(), torch.zeros(cfg.n_experts, dtype=torch.int64, device=dev)
    return layer


@pytest.mark.parametrize("index", [0, 5])  # a Mamba-2 layer, an attention layer
def test_layer_makes_no_host_sync(dev, index):
    layer = _layer(dev, index)
    t = 1030
    h = (torch.randn(2, t, layer.cfg.dim, device=dev) * 8).to(torch.bfloat16)
    mask = torch.ones(2, t, dtype=torch.bool, device=dev)
    mask[1, 900:] = False
    with torch.inference_mode():
        layer(h, None, mask, True)  # first use: kernel loads, cuBLAS handles
        torch.cuda.synchronize()
        before = launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = layer(h, None, mask, True)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = launch_counts()
    assert bool(torch.isfinite(out).all())
    assert int(layer.loads.sum()) == 2 * 2 * t * layer.cfg.top_k
    assert after["ssm_scan"] - before["ssm_scan"] == (1 if index == 0 else 0)
    assert after["moe_swiglu"] - before["moe_swiglu"] == 2 and after["moe_combine"] - before["moe_combine"] == 1


def test_granite_forward_counts_and_graph_replay(dev):
    """Granite-4.0-H-Small's 40 layers: 36 scans, 80 SwiGLUs and 40 combines
    a forward, for a page batch's image forward and for a caption batch,
    whose CUDA-graph replay equals its eager forward bit for bit and adds the
    same counts."""
    cfg = full_colpali_granite_config()
    colpali = ColPali(cfg, [2, 10, 11, 12, 13, 14], seed=0, device=dev, dtype=torch.bfloat16)
    lm = colpali.gemma
    want_counts = {"ssm_scan": lm.cfg.mamba_layers, "moe_swiglu": 2 * lm.cfg.layers, "moe_combine": lm.cfg.layers}
    assert want_counts == {"ssm_scan": 36, "moe_swiglu": 80, "moe_combine": 40}

    def counted(fn, *args):
        before = launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        after = launch_counts()
        return out, {k: after[k] - before[k] for k in want_counts}

    gen = torch.Generator(device=dev).manual_seed(0)
    pixels = torch.rand(2, cfg.vision.image_size, cfg.vision.image_size, 3, generator=gen, device=dev)
    ids = torch.randint(1, lm.cfg.vocab_size, (32, 24), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[16:, 19:] = 0
    ids = ids * mask
    try:
        with torch.inference_mode():
            out, counts = counted(colpali.image_fwd, pixels)
            assert counts == want_counts and bool(torch.isfinite(out).all())
            want, counts = counted(colpali._text, ids, mask)
            assert counts == want_counts
            for call in range(3):  # the first captures, the next replay
                got, counts = counted(colpali.text_fwd, ids, mask)
                assert torch.equal(got, want), call
                assert counts == want_counts, call
        assert len(colpali.text_graphs.graphs) == 1
    finally:
        del colpali, lm
        torch.cuda.empty_cache()
