"""The MoE layer of the DeepSeek decoder (``ops/moe.py``,
``models/deepseek.py``) on the card, at Kimi-VL-A3B's published widths.

Marked ``cuda``: each test skips where there is no CUDA device (decided in a
fixture, at run time). Run them on the card with

    python -m pytest --noconftest tests/test_torch_moe_cuda.py -q

- The grouped product (``torch._grouped_mm`` on bf16) equal to one product
  an expert over the same sorted rows, within 1e-2 of max|plain| (both
  accumulate bf16 products in f32, in other orders), and counted once a
  launch as ``grouped_mm``.
- No host sync inside a MoE layer: a whole layer (MLA through the fused
  attention kernel, routing, the sort, both grouped products, the combine
  and the shared experts) runs under ``torch.cuda.set_sync_debug_mode``
  "error", which raises at a synchronizing call.
- MLA's attention (q/k 192, the kernel's Dh 256 template) runs the
  mma.sync body: one ``fused_attention`` launch a layer, no
  ``fused_attention_wgmma``.
"""

import pytest
import torch

from multimodal_embedding_tpu_torch.models.arch import full_colpali_deepseek_config
from multimodal_embedding_tpu_torch.models.deepseek import DeepseekLayer
from multimodal_embedding_tpu_torch.ops import launch_counts
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from multimodal_embedding_tpu_torch.utils.profiling import Tally

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped product has no CPU mode here")
    return torch.device("cuda")


@pytest.fixture
def layer(dev):
    cfg = full_colpali_deepseek_config().gemma
    return DeepseekLayer(cfg, 1, gen=torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("tokens", [8 * 1030, 130])
def test_grouped_product_matches_one_product_an_expert(dev, layer, tokens):
    x = torch.randn(tokens, layer.cfg.dim, device=dev).to(torch.bfloat16)
    r = tmoe.route(x, layer.mlp["router"], layer.mlp["bias"], top_k=6, scale=2.446, normalize=True)
    before = launch_counts()["grouped_mm"]
    for w, rows in ((layer.mlp["w13"], x[r.token]), (layer.mlp["w2"], x[r.token][:, : layer.cfg.moe_dim])):
        got = tmoe.grouped_mm(rows.contiguous(), w, r.ends)
        want = tmoe._grouped_plain(rows.contiguous(), w, r.ends)
        assert float((got.float() - want.float()).abs().max()) <= 1e-2 * float(want.float().abs().max())
    assert launch_counts()["grouped_mm"] == before + 2


def test_moe_layer_makes_no_host_sync(dev, layer):
    t = 1030
    h = torch.randn(2, t, layer.cfg.dim, device=dev).to(torch.bfloat16)
    pos = torch.arange(t, device=dev).expand(2, t)
    layer.tally, layer.loads = Tally(), torch.zeros(layer.cfg.n_experts, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        layer(h, pos, None, True)  # first use: kernel loads, cuBLAS handles
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = layer(h, pos, None, True)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all())
    assert int(layer.loads.sum()) == 2 * 2 * t * 6


def test_mla_attention_runs_the_mma_sync_body(dev, layer):
    t = 130
    h = torch.randn(1, t, layer.cfg.dim, device=dev).to(torch.bfloat16)
    pos = torch.arange(t, device=dev).expand(1, t)
    layer.tally, layer.loads = Tally(), torch.zeros(layer.cfg.n_experts, dtype=torch.int64, device=dev)
    before = launch_counts()
    with torch.inference_mode():
        layer(h, pos, None, True)
        torch.cuda.synchronize()
    after = launch_counts()
    assert after["fused_attention"] - before["fused_attention"] == 1
    assert after["fused_attention_wgmma"] == before["fused_attention_wgmma"]
