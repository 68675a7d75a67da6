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
- The SwiGLU kernel (``csrc/moe.cu``) bit-equal to its plain composition
  (``ops/moe.py:swiglu_plain``) on every bf16 gate bit pattern against a
  spread of up values, in f32, and at the Kimi cell's shapes: the routed
  experts' ``[49440, 2816]``, the shared experts' ``[8240, 5632]`` and the
  dense layer's ``[8240, 22528]`` at a page batch.
- The combine kernel, with and without the shared experts' addend, bit-equal
  to the choice-order f32 composition written out, at a page batch's n
  8240, k 6, D 2048 with the layer's own routing. Against the plain
  ``combine``, which sums the choices in ATen's order, each element is
  within one bf16 step of the result plus what two f32 orders of k terms
  can part by, 2 (k - 1) 2^-24 sum_j |w_j y_j|: where the terms cancel,
  that is more than a bf16 step of the small result.
- A whole MoE layer launches two SwiGLUs and one combine, and a DeepSeek
  forward at Kimi-VL-A3B's full depth 53 and 26 (26 routed, 26 shared and
  one dense SwiGLU; a combine a MoE layer); a caption batch's CUDA-graph
  replay is bit-equal to the eager forward and adds the same counts.
"""

import pytest
import torch

from multimodal_embedding_tpu_torch.models.arch import full_colpali_deepseek_config
from multimodal_embedding_tpu_torch.models.colpali import ColPali
from multimodal_embedding_tpu_torch.models.deepseek import DeepseekLayer
from multimodal_embedding_tpu_torch.ops import launch_counts
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from multimodal_embedding_tpu_torch.ops import moe_cuda
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
        before = launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = layer(h, pos, None, True)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = launch_counts()
    assert bool(torch.isfinite(out).all())
    assert int(layer.loads.sum()) == 2 * 2 * t * 6
    # the routed and the shared experts' SwiGLU, one combine
    assert after["moe_swiglu"] - before["moe_swiglu"] == 2 and after["moe_combine"] - before["moe_combine"] == 1


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


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    num = ~want.isnan()
    assert torch.equal(got.view(bits)[num], want.view(bits)[num])


def test_swiglu_on_every_bf16_gate(dev):
    """All 65,536 gate bit patterns (NaNs, infinities, subnormals among
    them), each against five up values: normals at three scales, the gate's
    neighbour and an infinity or a zero."""
    gates = torch.arange(-(2**15), 2**15, dtype=torch.int32, device=dev).to(torch.int16).view(torch.bfloat16)
    gates = gates.view(256, 256)
    gen = torch.Generator(device=dev).manual_seed(1)
    ups = [(torch.randn(256, 256, generator=gen, device=dev) * s).to(torch.bfloat16) for s in (0.01, 1.0, 100.0)]
    ups += [gates.roll(1, 1), torch.where(gates.view(torch.int16) % 2 == 0, float("inf"), 0.0).to(torch.bfloat16)]
    for up in ups:
        h = torch.cat([gates, up], dim=1).contiguous()
        _bits_equal(moe_cuda.swiglu(h), tmoe.swiglu_plain(h))


@pytest.mark.parametrize("shape", [(49440, 2816), (8240, 5632), (8240, 22528), (37, 3, 48)],
                         ids=["routed", "shared", "dense", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_swiglu_is_the_plain_composition(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    h = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
    before = launch_counts()["moe_swiglu"]
    got = tmoe.swiglu(h)
    assert launch_counts()["moe_swiglu"] == before + 1
    _bits_equal(got, tmoe.swiglu_plain(h))


def _choice_order(y, r, shared):
    """The combine written out: each product in f32, the k products summed
    in choice order, rounded; then the shared output added and rounded."""
    prod = y[r.rows].float() * r.weights[..., None]
    acc = prod[:, 0]
    for j in range(1, prod.shape[1]):
        acc = acc + prod[:, j]
    out = acc.to(y.dtype)
    return out if shared is None else (out.float() + shared.float()).to(y.dtype)


def _bf16_step(x):
    """The spacing of bf16 values at |x| (0 at 0)."""
    a = x.float().abs()
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8), torch.zeros_like(a))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("tokens", [8 * 1030, 130])
def test_combine_is_the_choice_order_sum(dev, layer, tokens, dtype):
    cfg = layer.cfg
    gen = torch.Generator(device=dev).manual_seed(tokens)
    x = torch.randn(tokens, cfg.dim, generator=gen, device=dev).to(torch.bfloat16)
    r = tmoe.route(x, layer.mlp["router"], layer.mlp["bias"], top_k=cfg.top_k, scale=cfg.routed_scale,
                   normalize=True)
    y = (torch.randn(tokens * cfg.top_k, cfg.dim, generator=gen, device=dev) * 0.05).to(dtype)
    shared = (torch.randn(tokens, cfg.dim, generator=gen, device=dev) * 0.05).to(dtype)
    before = launch_counts()["moe_combine"]
    for s in (None, shared):
        _bits_equal(tmoe.combine(y, r, s), _choice_order(y, r, s))
    assert launch_counts()["moe_combine"] == before + 2
    if dtype == torch.bfloat16:  # ATen sums the choices in another order
        got, plain = tmoe.combine(y, r).float(), tmoe.combine_plain(y, r).float()
        terms = (y[r.rows].float() * r.weights[..., None]).abs().sum(dim=1)
        bound = _bf16_step(torch.maximum(got.abs(), plain.abs())) + 2 * (cfg.top_k - 1) * 2.0**-24 * terms
        assert bool(((got - plain).abs() <= bound).all())
    got, again = tmoe.combine(y, r, shared), tmoe.combine(y, r, shared)
    assert torch.equal(got, again)  # no atomics: the same bits every run


def test_deepseek_forward_counts_and_graph_replay(dev):
    """Kimi-VL-A3B's 27 layers: 53 SwiGLUs and 26 combines a forward, for
    a page batch's image forward and for a caption batch, whose CUDA-graph
    replay equals its eager forward bit for bit and adds the same counts."""
    cfg = full_colpali_deepseek_config()
    colpali = ColPali(cfg, [2, 10, 11, 12, 13, 14], seed=0, device=dev, dtype=torch.bfloat16)
    lm = colpali.gemma
    want_counts = {"moe_swiglu": 2 * lm.cfg.moe_layers + lm.cfg.first_dense, "moe_combine": lm.cfg.moe_layers}
    assert want_counts == {"moe_swiglu": 53, "moe_combine": 26}

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
