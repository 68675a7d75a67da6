"""Granite-4.0-H-Small's hybrid decoder on the card (``models/granite.py``,
``ops/ssm.py``, ``csrc/ssm.cu``), at its published widths.

Marked ``cuda``: each test skips where there is no CUDA device (decided in a
fixture, at run time). Run them on the card with

    python -m pytest --noconftest tests/test_torch_ssm_cuda.py -q

- The scan kernel (bf16: the chunked body on wgmma; f32: the recurrence
  token by token; the state in f32 registers either way) against its plain
  version (``ops/ssm.py:scan_plain``, the chunked form in f32) on the same
  inputs, at a page batch of the cell (8 x 1030 tokens, 128 heads of 64,
  state 128) and at ragged lengths: within one bf16 step of the plain output
  (both round an f32 result once; the two sum the state in other orders, and
  the plain form takes each decay as the difference of two f32 cumulative
  sums of up to a few hundred, about 3e-5 off) plus 1e-4 of the output's
  largest magnitude, and within 1e-4 of it in f32; counted once a launch as
  ``ssm_scan``, and a bf16 launch also as ``ssm_scan_chunked``.
- The chunked body around its chunk's edge (16, 63, 64, 65, 128 and 1030
  tokens at full width), at head dims that take its element-wise loads (20,
  7) or two blocks a head (96), and over 1030 tokens of decays near 1 (dt
  about 1e-3, A about -1): the same limit, and at most 1% of the outputs
  differ from the plain scan's bf16 output. The body's f32 sums agree with
  the plain form's to about 1e-6, so only outputs that close to a rounding
  boundary differ (0.04-0.11% in a CPU emulation of the body's roundings);
  one bf16 rounding of the carried state, the decays, W or the scaled x moves
  3-96% of them in the same emulation, and the plain scan over decays rounded
  to bf16 fails the near-1 case here.
- No host sync inside a layer: a Mamba-2 layer and an attention layer, each
  with its MoE block, run under ``torch.cuda.set_sync_debug_mode("error")``.
- A ColPali-Granite-4.0-H-Small forward launches 36 ``ssm_scan``, all 36
  on the chunked body (``ssm_scan_chunked``), 80 ``moe_swiglu`` (the routed
  and the shared expert a layer) and 40 ``moe_combine``; a caption batch's
  CUDA-graph replay equals its eager forward bit for bit and adds the same
  counts (its capture raises on any host sync).
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
    before = launch_counts()
    with torch.inference_mode():
        got = ssm.scan(*args, chunk=256)
        want = ssm.scan_plain(*args, chunk=256)
    after = launch_counts()
    assert after["ssm_scan"] == before["ssm_scan"] + 1
    assert after["ssm_scan_chunked"] == before["ssm_scan_chunked"] + (dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if dtype == torch.bfloat16:
        step = torch.finfo(torch.bfloat16).eps * w.abs()  # one bf16 step of the plain output
        assert bool(((g - w).abs() <= step + 1e-4 * top).all())
    else:
        assert float((g - w).abs().max()) <= 1e-4 * top


def _differing_share(got, want) -> float:
    """The share of bf16 outputs that differ from the plain scan's."""
    return float((got != want).float().mean())


def _near_one_inputs(dev, b, t, seed=0):
    """Full-width inputs whose decays sit near 1: dt about 1e-3, A about -1,
    so a decay of about 0.999 a token carries the state over the page."""
    x, dt, a, bm, cm, d = _inputs(dev, b, t, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dt = (1e-3 * (1 + 0.2 * torch.rand(dt.shape, generator=g, device=dev))).to(dt.dtype)
    a = -(0.8 + 0.4 * torch.rand(a.shape, generator=g, device=dev))
    return x, dt, a, bm, cm, d


def _check_chunked(args):
    before = launch_counts()
    with torch.inference_mode():
        got = ssm.scan(*args, chunk=256)
        want = ssm.scan_plain(*args, chunk=256)
    after = launch_counts()
    assert after["ssm_scan"] - before["ssm_scan"] == 1 and after["ssm_scan_chunked"] - before["ssm_scan_chunked"] == 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    g, w = got.float(), want.float()
    step = torch.finfo(torch.bfloat16).eps * w.abs()
    assert bool(((g - w).abs() <= step + 1e-4 * float(w.abs().max())).all())
    assert _differing_share(got, want) <= 0.01
    return want


# lengths around the chunk's edge at full width; then head dims that are not a
# multiple of 8 (the element-wise loads, an odd one stored a value at a time)
# and above 64 (two blocks a head)
@pytest.mark.parametrize("b, t, h, p, n", [(4, 16, 128, 64, 128), (3, 63, 128, 64, 128), (3, 64, 128, 64, 128),
                                           (3, 65, 128, 64, 128), (2, 128, 128, 64, 128), (2, 1030, 128, 64, 128),
                                           (2, 70, 6, 20, 32), (1, 40, 2, 7, 16), (2, 130, 4, 96, 64)])
def test_chunked_body_at_the_chunk_edge_and_other_layouts(dev, b, t, h, p, n):
    _check_chunked(_inputs(dev, b, t, h, p, n, seed=t + p))


def test_chunked_body_keeps_decays_near_one(dev):
    from perfbench import faults

    args = _near_one_inputs(dev, 2, 1030)
    want = _check_chunked(args)
    with torch.inference_mode():
        rounded = faults.scan_bf16_decays(*args, chunk=256)
    assert _differing_share(rounded, want) > 0.01


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
    """Granite-4.0-H-Small's 40 layers: 36 scans, each on the chunked body,
    80 SwiGLUs and 40 combines a forward, for a page batch's image forward and
    for a caption batch, whose CUDA-graph replay equals its eager forward bit
    for bit and adds the same counts."""
    cfg = full_colpali_granite_config()
    colpali = ColPali(cfg, [2, 10, 11, 12, 13, 14], seed=0, device=dev, dtype=torch.bfloat16)
    lm = colpali.gemma
    want_counts = {"ssm_scan": lm.cfg.mamba_layers, "ssm_scan_chunked": lm.cfg.mamba_layers,
                   "moe_swiglu": 2 * lm.cfg.layers, "moe_combine": lm.cfg.layers}
    assert want_counts == {"ssm_scan": 36, "ssm_scan_chunked": 36, "moe_swiglu": 80, "moe_combine": 40}

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
