"""Kimi-Linear's hybrid decoder on the card (``models/kimi_linear.py``,
``ops/kda.py``, ``csrc/kda.cu``), at its published widths.

Marked ``cuda``: each test skips where there is no CUDA device (decided in a
fixture, at run time). Run them on the card with

    python -m pytest --noconftest tests/test_torch_kda_cuda.py -q

- The KDA kernel against its plain version (``ops/kda.py:kda_plain``, the
  chunked form in f32, run on CPU copies of the same inputs) at a page batch's
  width (32 heads of 128) over 1030 tokens and at short and ragged lengths.
  Both compute the recurrence in f32 and differ by summing the state in other
  orders (the plain form also takes each pair's decay from two f32 cumulative
  sums of up to about a hundred, a few 1e-6 off): f32 within 1e-4 of the
  largest magnitude; bf16 within one bf16 step of the plain output (each
  rounds its f32 result once, so an output near a rounding boundary may land
  a step apart) plus the same 1e-4. Counted once a launch as ``kda_scan``.
- The kernel's 16-token stretch edges and the plain form's 64-token chunk
  edges (1, 15, 16, 17, 63, 64, 65 and 128 tokens) and strong decays (A up
  to 16, dt up to 1, a 64-token chunk's cumulative log decay below -100):
  the same limits, every output finite.
- Left-padded rows: a KDA layer's valid outputs for a row behind three pads
  equal the row's alone within 1e-2 relative (bf16 products of other shapes
  and other chunk boundaries; pads that reached the state would move them by
  their whole size).
- No host sync inside a layer: a KDA and an MLA layer, each with its MoE
  block, run under ``torch.cuda.set_sync_debug_mode("error")``.
- A ColPali forward of the benchmark's 16 layers at full width (16 experts a
  layer in place of 256, which leaves the launches as they are) launches 12
  ``kda_scan``; a caption batch's CUDA-graph replay equals its eager forward
  bit for bit and adds the same counts.
"""

import dataclasses
import math

import pytest
import torch

from multimodal_embedding_tpu_torch.models.arch import full_colpali_kimi_linear_config
from multimodal_embedding_tpu_torch.models.colpali import ColPali
from multimodal_embedding_tpu_torch.models.kimi_linear import KimiLinearLayer
from multimodal_embedding_tpu_torch.ops import kda, launch_counts
from multimodal_embedding_tpu_torch.utils.profiling import Tally

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the KDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, t, h=32, dtype=torch.bfloat16, seed=0, dt_max=0.1):
    """Inputs at the scale a KDA layer of the cell feeds the recurrence: q, k
    and v SiLU outputs, views into one [B, T, 3 H 128] tensor as the convs'
    output holds them; g from the initialiser's ranges (A in [1, 16] a head,
    dt log-uniform up to ``dt_max`` a channel); beta a sigmoid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = h * 128
    qkv = torch.nn.functional.silu(torch.randn(b, t, 3 * n, generator=gen, device=dev)).to(dtype)
    q, k, v = (x.unflatten(-1, (h, 128)) for x in qkv.split(n, dim=-1))
    a = 1 + 15 * torch.rand(h, generator=gen, device=dev)
    u = torch.rand(b, t, h, 128, generator=gen, device=dev)
    g = -a[:, None] * torch.exp(math.log(1e-3) + u * (math.log(dt_max) - math.log(1e-3)))
    beta = torch.sigmoid(torch.randn(b, t, h, generator=gen, device=dev))
    return q, k, v, g, beta


def _close(got, want, dtype):
    """The limits of the module's docstring."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    step = 2.0**-7 * want.abs() if dtype == torch.bfloat16 else 0.0
    return bool(((got - want).abs() <= step + 1e-4 * scale).all())


def _plain(args):
    return kda.kda_plain(*(x.cpu() for x in args))


@pytest.mark.parametrize("b, t, h", [(2, 1030, 32), (3, 37, 32), (2, 1, 4), (1, 300, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_the_plain_recurrence(dev, b, t, h, dtype):
    args = _inputs(dev, b, t, h, dtype)
    before = launch_counts()
    with torch.inference_mode():
        got = kda.kda(*args)
    after = launch_counts()
    assert got.dtype == dtype and got.shape == (b, t, h, 128) and got.is_contiguous()
    assert after["kda_scan"] - before["kda_scan"] == 1
    want = _plain(args)
    assert _close(got.cpu(), want, dtype)


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stretch_and_chunk_edges(dev, t, dtype):
    args = _inputs(dev, 2, t, 4, dtype, seed=t)
    with torch.inference_mode():
        got = kda.kda(*args)
    assert _close(got.cpu(), _plain(args), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strong_decays(dev, dtype):
    args = _inputs(dev, 2, 200, 4, dtype, seed=7, dt_max=1.0)
    assert float(torch.cumsum(args[3][:, :64], dim=1).min()) < -100
    with torch.inference_mode():
        got = kda.kda(*args)
    assert bool(torch.isfinite(got).all())
    assert _close(got.cpu(), _plain(args), dtype)


def _layer(dev, index):
    """Layer ``index`` of the benchmark's model at full width in bf16 (16
    experts in place of 256), its tally set."""
    cfg = dataclasses.replace(full_colpali_kimi_linear_config().gemma, n_experts=16)
    layer = KimiLinearLayer(cfg, index, gen=torch.Generator(device=dev).manual_seed(index), device=dev,
                            dtype=torch.bfloat16)
    layer.tally, layer.loads = Tally(), torch.zeros(cfg.n_experts, dtype=torch.int64, device=dev)
    return layer


def test_left_padded_rows_keep_their_valid_outputs(dev):
    layer = _layer(dev, 1)
    assert layer.kind == "kda"
    x = torch.randn(2, 40, 2304, device=dev, generator=torch.Generator(device=dev).manual_seed(1)).bfloat16()
    mask = torch.ones(2, 40, dtype=torch.bool, device=dev)
    mask[0, :3] = False
    with torch.inference_mode():
        both = layer.kda_mix(x, mask)
        alone = layer.kda_mix(x[:1, 3:].contiguous(), None)
    diff = both[0, 3:].float() - alone[0].float()
    assert float(diff.norm() / alone[0].float().norm()) < 1e-2


@pytest.mark.parametrize("index", [1, 3], ids=["kda", "mla"])
def test_no_host_sync_inside_a_layer(dev, index):
    layer = _layer(dev, index)
    h = torch.randn(2, 70, 2304, device=dev).bfloat16()
    mask = torch.ones(2, 70, device=dev, dtype=torch.long)
    mask[1, 50:] = 0
    positions = torch.cumsum(mask, dim=-1) - 1
    with torch.inference_mode():
        layer(h, positions, mask > 0, True)  # warm: the build, the first launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = layer(h, positions, mask > 0, True)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out.float()).all())


def test_forward_counts_and_graph_replay(dev):
    cfg = full_colpali_kimi_linear_config()
    cfg = dataclasses.replace(cfg, gemma=dataclasses.replace(cfg.gemma, n_experts=16))
    model = ColPali(cfg, [2, 10, 11, 12, 13, 14], seed=0, device=dev, dtype=torch.bfloat16)
    ids = torch.randint(1, 1000, (4, 23), device=dev)
    mask = torch.ones_like(ids)
    mask[2, 17:] = 0
    with torch.inference_mode():
        before = launch_counts()
        eager = model._text(ids, mask)
        assert launch_counts()["kda_scan"] - before["kda_scan"] == 12
        model.text_fwd(ids, mask)  # the capture
        before = launch_counts()
        replay = model.text_fwd(ids, mask)
        assert launch_counts()["kda_scan"] - before["kda_scan"] == 12
    assert torch.equal(replay, eager)
