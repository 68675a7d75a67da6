"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, at run time). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: attention 1e-5 in f32 and 2e-2 in bf16
against the plain version in f32 on the same inputs (the f32 kernel's own
cases also 1e-5 for max|d|/max|plain| and mean|d|/mean|plain|: a long key
row, Qwen3-14B's groups of 5 at Dh 128, fully masked rows); preprocess at least
99.9% bit-equal and within one quantization level; MaxSim max|d|/max|plain|
at most 1e-5 in f32 and 1e-4 in bf16 (bf16 products are exact in f32, so
only the order of the f32 sums differs), and two calls bit-equal; the prologue's x_new bit-equal to
the plain version in the same dtype and its y, and LayerNorm, within
max|d|/max|plain| 1e-5 in f32 and 1e-2 in bf16 against the plain version in
f32; the prologue's row pass alone: x_new bit-equal and h within
max|d|/max|plain| 1e-5 in f32 and 1e-2 in bf16 of the plain row pass in the
same dtype; the prologue's and LayerNorm's forwards equal with and without
the autograd Function, and LayerNorm on misaligned scale and bias views equal
to aligned copies; the MLP activation within one ulp (two in f32) of the plain
version in the same dtype and bit-equal on at least 99.9% of the elements
(every bf16 bit pattern; 10^7 random f32 and f16 values), NaN where it is NaN;
stacked-QKV attention bit-equal to the attention kernel on contiguous copies of
the three slices; ``fused_attention_wgmma`` counting every bf16 attention
launch at Dh <= 80 (the kernel's warpgroup body), those of a full-width
CLIP-L and SigLIP-400M encode too, and none at Dh 128 or 256. The decoders: f32-output products of
bf16 operands within max|d|/max|plain| 1e-5 of the product of f32 copies
(their grads within 1e-2 of autograd of that product), and
the debug Qwen3 and Gemma in f32 on the card (prefill through the attention
kernel) within 1e-4 of the CPU's plain path, with equal greedy tokens.
"""

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.ops import (
    activation_cuda,
    attention_cuda,
    fused_ln_matmul_cuda,
    launch_counts,
    layernorm_cuda,
    maxsim_cuda,
)
from multimodal_embedding_tpu_torch.ops.preprocess import PreprocessConfig, make_preprocess_fn, scale_shift
from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn

pytestmark = pytest.mark.cuda


def _count(*kernels: str) -> int:
    """Launches of ``kernels`` so far (``ops.launch_counts``)."""
    counts = launch_counts()
    return sum(counts[k] for k in kernels)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _key_mask(dev, b, tk):
    """Sequences alternately whole and cut to a third."""
    lengths = np.where(np.arange(b) % 2 == 0, tk, tk // 3)[:, None]
    return torch.from_numpy((np.arange(tk)[None, :] < lengths).astype(np.int32)).to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout,h,kvh,t,dh,causal,masked,b", [
    ("packed", 16, 16, 577, 64, False, False, 2),
    ("packed", 12, 12, 77, 64, True, True, 2),
    ("bhtd", 8, 2, 100, 72, True, True, 2),
    ("bhtd", 4, 1, 1030, 256, True, False, 2),
    ("packed", 16, 16, 1024, 72, False, False, 2),  # SigLIP-448 in ColPali
    ("packed", 8, 1, 1030, 256, False, False, 2),  # Gemma over image + suffix tokens
    ("packed", 8, 1, 32, 256, False, True, 2),  # Gemma text sweep: key mask, not causal
    # T past a 64-row query tile and a 64- or 32-key tile; each padded head
    # dim of the bf16 kernel (40 -> 64, 80, 128, 256)
    ("packed", 4, 4, 65, 40, False, True, 2),
    ("bhtd", 4, 2, 33, 80, True, True, 2),
    ("packed", 4, 4, 65, 128, True, False, 2),
    ("bhtd", 4, 1, 65, 256, False, True, 2),
    ("packed", 2, 1, 33, 256, True, True, 2),
    # the benchmark cells' own shapes: CLIP-L's and SigLIP-400M's vision
    # batches of 32, their caption batches of 128 (CLIP causal with a key
    # mask, SigLIP a key mask alone)
    ("packed", 16, 16, 577, 64, False, False, 32),
    ("packed", 16, 16, 729, 72, False, False, 32),
    ("packed", 12, 12, 77, 64, True, True, 128),
    ("packed", 16, 16, 64, 72, False, True, 128),
    # key rows that are no multiple of the warpgroup body's 64-key tile
    ("bhtd", 4, 2, 129, 72, True, True, 2),
    ("packed", 4, 4, 65, 80, False, False, 2),
])
def test_attention_kernel_matches_plain(dev, dtype, tol, layout, h, kvh, t, dh, causal, masked, b):
    rng = np.random.default_rng(0)
    shapes = ([(b, t, h * dh), (b, t, kvh * dh), (b, t, kvh * dh)] if layout == "packed"
              else [(b, h, t, dh), (b, kvh, t, dh), (b, kvh, t, dh)])
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype) for s in shapes)
    km = _key_mask(dev, b, t) if masked else None
    kw = dict(causal=causal, layout=layout, num_heads=h, num_kv_heads=kvh)
    got = attention_cuda.fused_attention(q, k, v, km, **kw)
    scale = dh ** -0.5
    want = attention_cuda._plain(q.float(), k.float(), v.float(), km, causal, scale, layout, h, kvh)
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq,tk,h,dh,masked,b", [
    (1, 729, 16, 72, False, 2),  # the SigLIP MAP head: one probe row over 729 keys
    (1, 65, 4, 80, True, 2),
    (70, 33, 4, 64, True, 2),  # more query rows than keys, past one 64-row query tile
    (1, 729, 16, 72, False, 32),  # the MAP head over a SigLIP-400M vision batch of 32
    # key rows that are no multiple of the warpgroup body's 64-key tile
    (3, 129, 4, 64, True, 2),
    (100, 65, 4, 72, True, 2),
    (200, 577, 2, 64, False, 2),
    (64, 729, 4, 80, True, 2),
])
def test_attention_cross_lengths_match_plain(dev, dtype, tol, tq, tk, h, dh, masked, b):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((b, tq, h * dh), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h * dh), dtype=np.float32)).to(dev, dtype)
            for _ in range(2))
    km = _key_mask(dev, b, tk) if masked else None
    got = attention_cuda.fused_attention(q, k, v, km, layout="packed", num_heads=h)
    want = attention_cuda._plain(q.float(), k.float(), v.float(), km, False, dh ** -0.5, "packed", h, h)
    assert got.shape == q.shape
    assert float((got.float() - want).abs().max()) <= tol


def test_map_head_cross_attention_goes_through_the_kernel(dev):
    """MultiHeadAttention with kv= at SigLIP-So400m's width: q comes out of a
    linear on the broadcast probe; the kernel takes its strides, launches
    once, and agrees with the f32-logit einsum path."""
    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(0)
    attn = layers.MultiHeadAttention(1152, 16, gen=gen, device=dev, dtype=torch.bfloat16)
    probe = torch.randn(1, 1, 1152, generator=gen, device=dev).to(torch.bfloat16).expand(4, 1, 1152)
    kv = torch.randn(4, 729, 1152, generator=gen, device=dev).to(torch.bfloat16)
    with runtime.using(attention="pallas"):
        n0 = _count("fused_attention", "fused_attention_f32")
        got = attn(probe, kv=kv)
        assert _count("fused_attention", "fused_attention_f32") == n0 + 1
    with runtime.using(attention="xla"):
        want = attn(probe, kv=kv)
    assert got.shape == (4, 1, 1152)
    d = (got.float() - want.float()).abs()
    assert float(d.max()) / float(want.float().abs().max()) <= 1e-2


def _assert_bf16_attention_close(got, want):
    """chip_smoke.py's bf16 attention limits: 2e-2 absolute, and 1e-2 for
    max|d|/max|plain| and mean|d|/mean|plain| (outputs shrink as key rows
    grow, so the absolute limit alone loosens with Tk)."""
    d = (got.float() - want).abs()
    assert float(d.max()) <= 2e-2
    assert float(d.max()) / float(want.abs().max()) <= 1e-2
    assert float(d.mean()) / float(want.abs().mean()) <= 1e-2


@pytest.mark.parametrize("layout,h,kvh,t,dh", [
    ("packed", 4, 4, 77, 64),
    ("bhtd", 4, 2, 100, 72),
    ("packed", 8, 1, 65, 256),
    # the warpgroup body with one warpgroup a block (rows fit in 64) and with
    # two over several key tiles
    ("packed", 4, 4, 64, 72),
    ("bhtd", 4, 2, 200, 40),
])
def test_attention_bf16_fully_masked_rows_are_exact_zeros(dev, layout, h, kvh, t, dh):
    rng = np.random.default_rng(10)
    b = 3
    shapes = ([(b, t, h * dh), (b, t, kvh * dh), (b, t, kvh * dh)] if layout == "packed"
              else [(b, h, t, dh), (b, kvh, t, dh), (b, kvh, t, dh)])
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, torch.bfloat16) for s in shapes)
    km_np = (np.arange(t)[None, :] < np.array([[t], [t // 2], [t]])).astype(np.int32)
    km_np[0, 0] = 0  # causal: query row 0 of sequence 0 sees no valid key
    km_np[2] = 0  # every row of sequence 2 is fully masked
    km = torch.from_numpy(km_np).to(dev)
    kw = dict(causal=True, layout=layout, num_heads=h, num_kv_heads=kvh)
    got = attention_cuda.fused_attention(q, k, v, km, **kw)
    want = attention_cuda._plain(q.float(), k.float(), v.float(), km, True, dh ** -0.5, layout, h, kvh)
    o4 = got if layout == "bhtd" else got.reshape(b, t, h, dh).transpose(1, 2)
    assert bool((o4[2] == 0).all())
    assert bool((o4[0, :, 0] == 0).all())
    _assert_bf16_attention_close(got, want)


@pytest.mark.parametrize("dh,body", [(40, 1), (64, 1), (72, 1), (80, 1), (128, 0), (256, 0)])
def test_the_warpgroup_body_counts_once_a_launch_up_to_dh_80(dev, dh, body):
    """``fused_attention_wgmma`` moves once a bf16 launch at Dh <= 80 (the
    warpgroup body), never at Dh 128 and 256 (the mma.sync body) nor in f32;
    ``fused_attention`` and ``fused_attention_qkv`` stay the totals."""
    rng = np.random.default_rng(12)
    h = 4
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, h * dh), dtype=np.float32)).to(dev, dtype)
                   for _ in range(3))
        qkv = torch.cat([q, k, v], dim=-1)
        before = launch_counts()
        attention_cuda.fused_attention(q, k, v, layout="packed", num_heads=h)
        attention_cuda.fused_attention_qkv(qkv, num_heads=h)
        after = launch_counts()
        d = {key: after[key] - before[key] for key in after}
        bf16 = dtype == torch.bfloat16
        assert d["fused_attention" if bf16 else "fused_attention_f32"] == 1
        assert d["fused_attention_qkv"] == 1
        assert d["fused_attention_wgmma"] == (2 * body if bf16 else 0)


@pytest.mark.parametrize("name", ["OpenAI-CLIP-L", "SigLIP-400M"])
def test_every_attention_launch_of_an_encode_runs_the_warpgroup_body(dev, name):
    """A dual encoder at full width (Dh 64; 72 with SigLIP's MAP head): its
    image batch and caption batch launch the attention kernel once a layer
    (and once for the MAP head), and every launch counts as
    ``fused_attention_wgmma``."""
    from multimodal_embedding_tpu_torch.models.arch import full_arch_config
    from multimodal_embedding_tpu_torch.models.towers import DualEncoder

    cfg = full_arch_config(name)
    model = DualEncoder(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    s = cfg.vision.image_size
    pixels = torch.randn(4, s, s, 3, generator=gen, device=dev)
    ids = torch.randint(1, cfg.text.vocab_size, (8, cfg.text.max_len), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[4:, cfg.text.max_len // 2 :] = 0
    before = launch_counts()
    with torch.inference_mode():
        model.encode_image(pixels)
        model.text(ids * mask, mask)  # the eager forward a caption batch's graph replays
        torch.cuda.synchronize()
    after = launch_counts()
    d = {key: after[key] - before[key] for key in after}
    map_head = cfg.vision.style == "siglip" and cfg.vision.use_head
    expected = cfg.vision.layers + int(map_head) + cfg.text.layers
    assert d["fused_attention"] + d["fused_attention_qkv"] == expected
    assert d["fused_attention_wgmma"] == expected


def test_attention_bf16_takes_a_long_key_row(dev):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 4096, 64), dtype=np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    got = attention_cuda.fused_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention_cuda._plain(q.float(), k.float(), v.float(), None, False, 0.125, "bhtd", 2, 2)
    _assert_bf16_attention_close(got, want)


def _assert_f32_attention_close(got, want):
    """chip_smoke.py's f32 attention limits: 1e-5 absolute, and 1e-5 for
    max|d|/max|plain| and mean|d|/mean|plain|."""
    d = (got - want).abs()
    assert got.dtype == torch.float32
    assert float(d.max()) <= 1e-5
    assert float(d.max()) / float(want.abs().max()) <= 1e-5
    assert float(d.mean()) / float(want.abs().mean()) <= 1e-5


def test_attention_f32_takes_a_long_key_row(dev):
    """4096 keys: the f32 kernel keeps its logits in registers, so no key
    row length is refused."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 4096, 64), dtype=np.float32)).to(dev) for _ in range(3))
    before = _count("fused_attention_f32")
    got = attention_cuda.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert _count("fused_attention_f32") == before + 1
    _assert_f32_attention_close(got, attention_cuda._plain(q, k, v, None, False, 0.125, "bhtd", 2, 2))


@pytest.mark.parametrize("layout", ["packed", "bhtd"])
def test_attention_f32_gqa_groups_of_5_at_dh_128(dev, layout):
    """Qwen3-14B's grouping cut to 10 query heads over 2 KV heads, Dh 128,
    causal and left-padded (a prefill): every pad query row is fully masked
    and exact zeros."""
    rng = np.random.default_rng(16)
    b, h, kvh, t, dh = 3, 10, 2, 100, 128
    shapes = ([(b, t, h * dh), (b, t, kvh * dh), (b, t, kvh * dh)] if layout == "packed"
              else [(b, h, t, dh), (b, kvh, t, dh), (b, kvh, t, dh)])
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev) for s in shapes)
    lengths = np.array([t, 37, 1])
    km = torch.from_numpy((np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)).to(dev)
    kw = dict(causal=True, layout=layout, num_heads=h, num_kv_heads=kvh)
    got = attention_cuda.fused_attention(q, k, v, km, **kw)
    want = attention_cuda._plain(q, k, v, km, True, dh ** -0.5, layout, h, kvh)
    _assert_f32_attention_close(got, want)
    o4 = got if layout == "bhtd" else got.reshape(b, t, h, dh).transpose(1, 2)
    for i, n in enumerate(lengths):
        assert bool((o4[i, :, : t - n] == 0).all())


@pytest.mark.parametrize("layout,h,kvh,t,dh", [
    ("packed", 4, 4, 77, 64),
    ("bhtd", 4, 2, 100, 72),
    ("packed", 8, 1, 65, 256),
])
def test_attention_f32_fully_masked_rows_are_exact_zeros(dev, layout, h, kvh, t, dh):
    rng = np.random.default_rng(17)
    b = 3
    shapes = ([(b, t, h * dh), (b, t, kvh * dh), (b, t, kvh * dh)] if layout == "packed"
              else [(b, h, t, dh), (b, kvh, t, dh), (b, kvh, t, dh)])
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev) for s in shapes)
    km_np = (np.arange(t)[None, :] < np.array([[t], [t // 2], [t]])).astype(np.int32)
    km_np[0, 0] = 0  # causal: query row 0 of sequence 0 sees no valid key
    km_np[2] = 0  # every row of sequence 2 is fully masked
    km = torch.from_numpy(km_np).to(dev)
    kw = dict(causal=True, layout=layout, num_heads=h, num_kv_heads=kvh)
    got = attention_cuda.fused_attention(q, k, v, km, **kw)
    want = attention_cuda._plain(q, k, v, km, True, dh ** -0.5, layout, h, kvh)
    o4 = got if layout == "bhtd" else got.reshape(b, t, h, dh).transpose(1, 2)
    assert bool((o4[2] == 0).all())
    assert bool((o4[0, :, 0] == 0).all())
    _assert_f32_attention_close(got, want)


def test_attention_gradient_recomputes_through_plain_version(dev):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 33, 128), dtype=np.float32)).to(dev) for _ in range(3))
    km = torch.ones(2, 33, dtype=torch.int32, device=dev)
    km[1, 20:] = 0
    grads = []
    for fn in (attention_cuda.fused_attention, None):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        if fn is None:
            out = attention_cuda._plain(*xs, km, True, 32 ** -0.5, "packed", 4, 4)
        else:
            out = fn(*xs, km, causal=True, layout="packed", num_heads=4)
        (out ** 2).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4


def test_attention_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q = torch.zeros(2, 10, 4 * 12, device=dev)  # Dh 12: not a multiple of 8
    with pytest.raises(ValueError):
        attention_cuda.fused_attention(q, q, q, layout="packed", num_heads=4)
    q16 = torch.zeros(2, 10, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        attention_cuda.fused_attention(q16, q16, q16, layout="packed", num_heads=1)


@pytest.mark.parametrize("mode,size", [("shortest_edge", 336), ("exact", 448)])
@pytest.mark.parametrize("h,w", [(480, 640), (640, 480), (480, 480), (427, 640)])
def test_preprocess_kernel_matches_plain(dev, h, w, mode, size):
    cfg = PreprocessConfig(image_size=size, resize_mode=mode)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 3, h, w), dtype=np.uint8)).to(dev)
    got = make_preprocess_cuda_fn(cfg, h, w, device=dev)(x)
    want = make_preprocess_fn(cfg, h, w, device=dev, input_format="nchw")(x)
    assert float((got == want).float().mean()) >= 0.999
    level = scale_shift(cfg)[0]
    for ch in range(3):
        assert float((got - want)[..., ch].abs().max()) <= level[ch] * (1 + 1e-5) + 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-4)])
@pytest.mark.parametrize("nq,tq,nd,td,dim,masked", [
    (9, 32, 13, 1030, 128, False),  # ColPali T2I: text queries x image docs
    (5, 1030, 21, 32, 128, False),  # ColPali I2T: image queries x text docs
    (7, 33, 11, 65, 16, True),  # tails of every tile, masks
    (3, 130, 9, 7, 8, True),  # a query over two row tiles, a short doc
])
def test_maxsim_kernel_matches_plain(dev, dtype, tol, nq, tq, nd, td, dim, masked):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((nq, tq, dim), dtype=np.float32)).to(dev, dtype)
    d = torch.from_numpy(rng.standard_normal((nd, td, dim), dtype=np.float32)).to(dev, dtype)
    qm = dm = None
    if masked:
        qm = torch.from_numpy((rng.random((nq, tq)) > 0.2).astype(np.float32)).to(dev)
        dm_np = rng.random((nd, td)) > 0.3
        dm_np[0] = False  # a doc with no valid token: -1e30 per weighted query token
        dm = torch.from_numpy(dm_np).to(dev)
    before = _count("maxsim", "maxsim_f32")
    got = maxsim_cuda.maxsim_scores(q, d, qm, dm, impl="pallas")
    torch.cuda.synchronize()
    assert _count("maxsim", "maxsim_f32") == before + 1
    want = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm)
    assert got.dtype == torch.float32 and got.shape == (nq, nd)
    if masked:  # the empty doc's column is exact sums of -1e30
        np.testing.assert_allclose(got[:, 0].cpu().numpy(), want[:, 0].cpu().numpy(), rtol=1e-6)
        got, want = got[:, 1:], want[:, 1:]
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _maxsim_inputs(dev, dtype, nq, tq, nd, td, dim, seed, masked=False, empty_doc=None):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((nq, tq, dim), dtype=np.float32)).to(dev, dtype)
    d = torch.from_numpy(rng.standard_normal((nd, td, dim), dtype=np.float32)).to(dev, dtype)
    qm = dm = None
    if masked or empty_doc is not None:
        qm = torch.from_numpy((rng.random((nq, tq)) > 0.2).astype(np.float32)).to(dev)
        dm_np = rng.random((nd, td)) > (0.3 if masked else -1.0)
        if empty_doc is not None:
            dm_np[empty_doc] = False
        dm = torch.from_numpy(dm_np).to(dev)
    return q, d, qm, dm


@pytest.mark.parametrize("nq,tq,nd,td,dim,masked,empty_doc", [
    (6, 32, 7, 1030, 128, False, None),  # TD 1030: docs packed across 128-token ring tiles
    (3, 1030, 9, 32, 128, False, None),  # TQ 1030: 17 row tiles of 64, the last with 6 rows
    (5, 100, 11, 77, 128, True, None),  # TQ not a multiple of 64, TD not a multiple of 8
    (4, 45, 6, 130, 8, True, None),  # D 8, warps spanning two queries
    (9, 20, 13, 40, 16, False, None),  # D 16, six queries a row tile
    (2, 64, 1001, 32, 128, False, None),  # ND not a multiple of any slice
    (5, 33, 8, 129, 128, False, 3),  # a doc with no valid token, one token past a tile
    (3, 40, 20, 16, 128, True, None),  # 8 whole docs a ring tile
    (2, 70, 5, 128, 64, False, 1),  # one whole doc a ring tile, one with no valid token
])
def test_maxsim_bf16_kernel_edges(dev, nq, tq, nd, td, dim, masked, empty_doc):
    q, d, qm, dm = _maxsim_inputs(dev, torch.bfloat16, nq, tq, nd, td, dim, 4, masked, empty_doc)
    got = maxsim_cuda.maxsim_cuda(q, d, qm, dm)
    torch.cuda.synchronize()
    want = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm)
    if empty_doc is not None:  # exact sums of -1e30
        np.testing.assert_allclose(got[:, empty_doc].cpu().numpy(), want[:, empty_doc].cpu().numpy(), rtol=1e-6)
        keep = [j for j in range(nd) if j != empty_doc]
        got, want = got[:, keep], want[:, keep]
    assert bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_maxsim_kernel_is_deterministic(dev, dtype):
    q, d, qm, dm = _maxsim_inputs(dev, dtype, 7, 1030, 40, 32, 128, 5, masked=True)
    a = maxsim_cuda.maxsim_cuda(q, d, qm, dm)
    b = maxsim_cuda.maxsim_cuda(q, d, qm, dm)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_maxsim_f32_kernel_at_a_cut_of_the_search_shape(dev):
    """A search's shape cut to 8 queries of 32 tokens against 512 docs of
    1030 tokens (unit-norm f32, as encode_cli writes): each doc packed
    across 64-token ring tiles (td8 1032), one launch of the f32 kernel,
    within max|d|/max|plain| 1e-5."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(8, 32, 128, generator=g, device=dev)
    d = torch.randn(512, 1030, 128, generator=g, device=dev)
    q, d = q / q.norm(dim=-1, keepdim=True), d / d.norm(dim=-1, keepdim=True)
    before, before_f32 = _count("maxsim", "maxsim_f32"), _count("maxsim_f32")
    got = maxsim_cuda.maxsim_scores(q, d)
    torch.cuda.synchronize()
    assert (_count("maxsim", "maxsim_f32"), _count("maxsim_f32")) == (before + 1, before_f32 + 1)
    want = maxsim_cuda.maxsim_scores_ref(q, d)
    assert got.shape == (8, 512) and bool(got.isfinite().all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_maxsim_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q = torch.zeros(2, 3, 12, device=dev, dtype=torch.bfloat16)  # D 12: not a multiple of 8
    with pytest.raises(ValueError):
        maxsim_cuda.maxsim_cuda(q, q)
    q16 = torch.zeros(2, 3, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        maxsim_cuda.maxsim_cuda(q16, q16)
    big = torch.zeros(2, 3, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        maxsim_cuda.maxsim_cuda(big, big)


def _rel(got, want):
    return float((got.float() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,d,n,has_delta,act,norm", [
    (130, 1024, 384, True, None, "ln"),  # ViT-L width, rows over three row tiles
    (77, 768, 520, True, "quick_gelu", "ln"),  # CLIP text width, N past a tile edge
    (33, 1152, 4304 // 8, False, "gelu_pytorch_tanh", "ln"),  # SigLIP width, no delta
    (17, 64, 48, True, "gelu", "ln"),
    (24, 40, 37, True, None, "rms_gemma"),  # D not a multiple of 16, odd N
    # M across the 128-row output tile, N across the column tile, D past a
    # depth slice of 32 and past the row pass's warp-per-row width
    (1, 1024, 136, True, None, "ln"),
    (127, 768, 8, True, "quick_gelu", "ln"),
    (129, 2048, 4304, False, "gelu_pytorch_tanh", "ln"),
    (257, 40, 4304, True, "gelu", "ln"),
    (257, 8192, 136, True, None, "rms_gemma"),
    (129, 8192, 8, False, "quick_gelu", "ln"),
])
def test_prologue_kernel_matches_plain(dev, dtype, tol, m, d, n, has_delta, act, norm):
    rng = np.random.default_rng(4)

    def rand(shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * s).to(dev, dtype)

    x, delta = rand((m, d)), rand((m, d)) if has_delta else None
    gamma = rand((d,), 0.1)
    beta, b = (rand((d,), 0.1), rand((n,), 0.1)) if norm == "ln" else (None, None)
    w = rand((d, n), d ** -0.5)
    before = _count("fused_res_norm_matmul")
    x_new, y = fused_ln_matmul_cuda.fused_res_norm_matmul(x, delta, gamma, beta, w, b, norm=norm, act=act)
    torch.cuda.synchronize()
    assert _count("fused_res_norm_matmul") == before + 1
    want_x, _ = fused_ln_matmul_cuda.reference(x, delta, gamma, beta, w, b, norm=norm, act=act)
    f32 = [None if t is None else t.float() for t in (x, delta, gamma, beta, w, b)]
    _, want_y = fused_ln_matmul_cuda.reference(*f32, norm=norm, act=act)
    assert torch.equal(x_new, want_x)
    assert y.dtype == dtype and y.shape == (m, n)
    assert _rel(y, want_y) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,d,has_delta,norm", [
    (1, 1024, True, "ln"),
    (129, 768, False, "ln"),
    (37, 1152, True, "rms_gemma"),
    (17, 2048, True, "ln"),
    (9, 8192, False, "ln"),  # a block per row
    (5, 40, True, "rms_gemma"),
])
def test_prologue_row_pass_matches_plain(dev, dtype, tol, m, d, has_delta, norm):
    """The row pass alone: x_new bit-equal and h within max|d|/max|plain|
    ``tol`` of the plain row pass in the same dtype (bf16: one rounding of h
    may land on the neighbouring value, 2^-8 relative)."""
    rng = np.random.default_rng(12)

    def rand(shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * s).to(dev, dtype)

    x, delta = rand((m, d)), rand((m, d)) if has_delta else None
    gamma, beta = rand((d,), 0.1), rand((d,), 0.1) if norm == "ln" else None
    before = _count("fused_res_norm_rows")
    x_new, h = fused_ln_matmul_cuda.fused_res_norm_rows(x, delta, gamma, beta, norm=norm, eps=1e-6)
    torch.cuda.synchronize()
    assert _count("fused_res_norm_rows") == before + 1
    want_x, want_h = fused_ln_matmul_cuda.reference_rows(x, delta, gamma, beta, norm=norm, eps=1e-6)
    assert torch.equal(x_new, want_x)
    assert h.dtype == dtype
    assert _rel(h, want_h.float()) <= tol


def test_prologue_forward_is_the_same_with_and_without_grad(dev):
    """With an input that needs a gradient the call goes through the autograd
    Function; under inference it launches directly: the same tensors."""
    rng = np.random.default_rng(13)
    ins = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.3).to(dev, torch.bfloat16)
           for s in ((3, 50, 768), (3, 50, 768), (768,), (768,), (768, 520), (520,))]
    with torch.no_grad():
        plain = fused_ln_matmul_cuda.fused_res_norm_matmul(*ins, act="quick_gelu")
    graded = fused_ln_matmul_cuda.fused_res_norm_matmul(ins[0].clone().requires_grad_(), *ins[1:], act="quick_gelu")
    assert graded[1].requires_grad
    for a, b in zip(plain, graded):
        assert torch.equal(a, b.detach())


def test_prologue_gradient_recomputes_through_plain_version(dev):
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.3).to(dev)
           for s in ((2, 9, 64), (2, 9, 64), (64,), (64,), (64, 40), (40,))]
    grads = []
    for fn in (fused_ln_matmul_cuda.fused_res_norm_matmul, fused_ln_matmul_cuda.reference):
        xs = [t.clone().requires_grad_() for t in ins]
        x_new, y = fn(*xs, norm="ln", eps=1e-5, act="quick_gelu")
        ((x_new ** 2).sum() + (y ** 2).sum()).backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4


def test_prologue_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.zeros(4, 12, device=dev)  # D 12: not a multiple of 8
    with pytest.raises(ValueError):
        fused_ln_matmul_cuda.fused_res_norm_matmul(x, None, torch.ones(12, device=dev), None,
                                                   torch.zeros(12, 8, device=dev), None)
    x16 = torch.zeros(4, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fused_ln_matmul_cuda.fused_res_norm_matmul(x16, None, torch.ones(16, device=dev, dtype=torch.float16),
                                                   None, torch.zeros(16, 8, device=dev, dtype=torch.float16), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,t,dh,causal,masked", [
    (16, 16, 577, 64, False, False),  # ViT-L
    (12, 12, 77, 64, True, True),  # CLIP text
    (16, 16, 64, 72, False, False),  # SigLIP's Dh 72
    (8, 2, 40, 32, True, True),  # grouped-query stacking
    (16, 16, 729, 72, False, False),  # SigLIP-400M's vision: two warpgroups a block at Dh 72
    (12, 12, 129, 64, True, True),  # past two 64-key tiles, causal with a key mask
])
def test_attention_qkv_kernel_equals_attention_on_copies(dev, dtype, h, kvh, t, dh, causal, masked):
    rng = np.random.default_rng(6)
    b = 2
    qkv = torch.from_numpy(rng.standard_normal((b, t, (h + 2 * kvh) * dh), dtype=np.float32)).to(dev, dtype)
    km = None
    if masked:
        km = torch.from_numpy((np.arange(t)[None, :] < np.array([[t], [t // 3]])).astype(np.int32)).to(dev)
    before = _count("fused_attention_qkv")
    got = attention_cuda.fused_attention_qkv(qkv, km, causal=causal, num_heads=h, num_kv_heads=kvh)
    assert _count("fused_attention_qkv") == before + 1
    q, k, v = (s.contiguous() for s in attention_cuda._split_qkv(qkv, h, kvh))
    want = attention_cuda.fused_attention(q, k, v, km, causal=causal, layout="packed", num_heads=h,
                                          num_kv_heads=kvh)
    assert torch.equal(got, want)


def test_attention_qkv_gradient_recomputes_through_plain_version(dev):
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 33, 3 * 128), dtype=np.float32)).to(dev)
    km = torch.ones(2, 33, dtype=torch.int32, device=dev)
    km[1, 20:] = 0
    grads = []
    for kernel in (True, False):
        x = qkv.clone().requires_grad_()
        if kernel:
            out = attention_cuda.fused_attention_qkv(x, km, causal=True, num_heads=4)
        else:
            out = attention_cuda._plain_qkv(x, km, True, 32 ** -0.5, 4, 4)
        (out ** 2).sum().backward()
        grads.append(x.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,d", [
    (130, 1024), (37, 1152), (9, 40), (5, 2048), (3, 6144),
    # the towers' widths (3, 4, 5 and 8 vectors a lane in bf16), one row, and
    # row counts that are not a multiple of the 8 rows a block
    (1, 768), (1001, 768), (1, 1024), (4099, 1024), (1, 1152), (8193, 1152), (1, 2048), (61, 2048),
    (1, 6144), (11, 6144),
])
def test_layer_norm_kernel_matches_plain(dev, dtype, tol, m, d):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((m, d), dtype=np.float32) * 2 + 0.5).to(dev, dtype)
    s, b = (torch.from_numpy(rng.standard_normal(d, dtype=np.float32)).to(dev, dtype) for _ in range(2))
    before = _count("fused_layer_norm")
    got = layernorm_cuda.fused_layer_norm(x, s, b, eps=1e-6)
    torch.cuda.synchronize()
    assert _count("fused_layer_norm") == before + 1
    want = layernorm_cuda.reference(x.float(), s.float(), b.float(), eps=1e-6)
    assert got.dtype == dtype
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("d", [1152, 6144])
def test_layer_norm_kernel_takes_a_misaligned_scale_view(dev, dtype, tol, d):
    """scale and bias as views one element into a buffer (not 16-byte aligned)."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((19, d), dtype=np.float32)).to(dev, dtype)
    buf = torch.from_numpy(rng.standard_normal(2 * d + 2, dtype=np.float32)).to(dev, dtype)
    s, b = buf[1 : d + 1], buf[d + 2 :]
    assert s.data_ptr() % 16 and b.is_contiguous()
    got = layernorm_cuda.fused_layer_norm(x, s, b, eps=1e-5)
    want = layernorm_cuda.reference(x.float(), s.float(), b.float(), eps=1e-5)
    assert _rel(got, want) <= tol
    with torch.no_grad():
        aligned = layernorm_cuda.fused_layer_norm(x, s.clone(), b.clone(), eps=1e-5)
    assert torch.equal(got, aligned)


def test_layer_norm_gradient_recomputes_through_plain_version(dev):
    rng = np.random.default_rng(9)
    ins = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev) for s in ((7, 64), (64,), (64,))]
    grads = []
    for fn in (layernorm_cuda.fused_layer_norm, layernorm_cuda.reference):
        xs = [t.clone().requires_grad_() for t in ins]
        (fn(*xs, eps=1e-5) ** 2).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4


def test_f32_products_of_bf16_operands_on_the_card(dev):
    """The decoders' f32-output products (LM head, Qwen3's gate and up, the
    decode step's logits) take bf16 operands with no f32 copy and match the
    product of f32 copies to f32 rounding (bf16 products are exact in f32)."""
    from multimodal_embedding_tpu_torch.models.decoder_attn import _bmm_f32
    from multimodal_embedding_tpu_torch.models.layers import matmul_f32

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3, 5, 256, generator=g, device=dev).bfloat16()
    w = torch.randn(256, 1000, generator=g, device=dev).bfloat16()
    table = torch.randn(1000, 256, generator=g, device=dev).bfloat16()
    for weight in (w, table.T):  # untied head, and a tied head's transposed view
        got = matmul_f32(x, weight)
        assert got.dtype == torch.float32 and got.shape == (3, 5, 1000)
        assert _rel(got, x.float() @ weight.float()) <= 1e-5
    a = torch.randn(16, 5, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(16, 300, 128, generator=g, device=dev).bfloat16()
    got = _bmm_f32(a, k.transpose(1, 2))
    assert got.dtype == torch.float32 and _rel(got, a.float() @ k.float().transpose(1, 2)) <= 1e-5


def test_f32_products_of_bf16_operands_have_grads_on_the_card(dev):
    """Where autograd records it, ``matmul_f32`` of bf16 operands goes
    through its Function: x's and w's grads in bf16 within
    max|d|/max|plain| 1e-2 of autograd of the product of f32 copies (the
    output grad is rounded to bf16 once); a frozen w gets none."""
    from multimodal_embedding_tpu_torch.models.layers import matmul_f32

    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn(3, 5, 256, generator=g, device=dev).bfloat16()
    w0 = (torch.randn(256, 1000, generator=g, device=dev) * 0.05).bfloat16()
    dy = torch.randn(3, 5, 1000, generator=g, device=dev)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = matmul_f32(x, w)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    xp, wp = x0.float().requires_grad_(), w0.float().requires_grad_()
    gxp, gwp = torch.autograd.grad(xp @ wp, (xp, wp), dy)
    assert gx.dtype == gw.dtype == torch.bfloat16
    assert _rel(gx.float(), gxp) <= 1e-2 and _rel(gw.float(), gwp) <= 1e-2
    x = x0.clone().requires_grad_()
    (gx_only,) = torch.autograd.grad(matmul_f32(x, w0), (x,), dy)
    assert torch.equal(gx_only, gx)


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_decoder_generation_on_the_card_matches_the_cpu(dev, arch):
    """The debug decoders of ``cli/train_rl.py`` in f32: the prefill (through
    the attention kernel, one launch a layer) matches the CPU's plain path at
    valid positions within 1e-4, and greedy tokens are equal."""
    from multimodal_embedding_tpu_torch.cli.train_rl import default_gemma_config, default_qwen3_config
    from multimodal_embedding_tpu_torch.rl import tokenizer as tok
    from multimodal_embedding_tpu_torch.rl.generate import generate
    from multimodal_embedding_tpu_torch.rl.policy import get_arch

    cfg = default_qwen3_config("debug") if arch == "qwen3" else default_gemma_config("debug")
    cpu = get_arch(arch).init(cfg, seed=0, device="cpu")
    card = get_arch(arch).init(cfg, seed=0, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()}, assign=True)
    ids, mask = tok.pad_left([tok.encode(t) for t in ("where is my package", "hi", "refund my card please")])
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want, _ = cpu.prefill(ids, mask, ids.shape[1])
        a0 = _count("fused_attention", "fused_attention_f32")
        got, _ = card.prefill(ids.to(dev), mask.to(dev), ids.shape[1])
    assert _count("fused_attention", "fused_attention_f32") == a0 + cfg.layers
    valid = mask.bool()
    assert float((got.cpu()[valid] - want[valid]).abs().max()) <= 1e-4
    toks, _ = generate(card, ids.to(dev), mask.to(dev), 8, greedy=True)
    assert torch.equal(toks.cpu(), generate(cpu, ids, mask, 8, greedy=True)[0])


# --- the towers' MLP activation ------------------------------------------------

ACTS = ("gelu", "quick_gelu", "gelu_pytorch_tanh")


def _ulps(got, want):
    """Distance in units in the last place between two tensors of one float
    dtype, element by element (+0 and -0 the same point)."""
    narrow = got.element_size() == 2
    bits, mag = (torch.int16, 0x7FFF) if narrow else (torch.int32, 0x7FFFFFFF)

    def ordered(t):
        b = t.view(bits).to(torch.int64)
        return torch.where(b < 0, -(b & mag), b & mag)

    return (ordered(got) - ordered(want)).abs()


def _against_plain(h, act, max_ulps, min_equal):
    """The kernel on ``h`` (one launch) against the plain version: NaN where
    it is NaN, elsewhere within ``max_ulps`` and bit-equal on at least
    ``min_equal`` of the elements."""
    before = _count("mlp_activation")
    got = activation_cuda.mlp_activation(h, act)
    torch.cuda.synchronize()
    assert _count("mlp_activation") == before + 1
    want = activation_cuda.reference(h, act)
    assert got.dtype == h.dtype and got.shape == h.shape
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    d = _ulps(got, want)[~nan]
    assert int(d.max()) <= max_ulps
    assert float((d == 0).double().mean()) >= min_equal


@pytest.mark.parametrize("act", ACTS)
def test_activation_kernel_on_every_bf16_value(dev, act):
    """All 65,536 bf16 bit patterns: finite values, both infinities, NaNs
    (NaN in gives NaN out); at most one bf16 ulp from the plain version and
    bit-equal on at least 99.9%."""
    x = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16).view(torch.bfloat16)
    _against_plain(x, act, max_ulps=1, min_equal=0.999)
    assert bool(activation_cuda.mlp_activation(x, act)[x.isnan()].isnan().all())


@pytest.mark.parametrize("dtype,max_ulps", [(torch.float32, 2), (torch.float16, 1)], ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_activation_kernel_on_random_f32_and_f16(dev, act, dtype, max_ulps):
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn(10_000_000, generator=gen, device=dev) * 3).to(dtype)
    _against_plain(x, act, max_ulps=max_ulps, min_equal=0.999)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", [(1,), (7,), (9,), (3, 77, 13), (8 * 1024 * 3 + 5,), (5, 8 * 1024 * 4 + 3)])
def test_activation_kernel_on_ragged_sizes(dev, dtype, shape):
    """Element counts that are not a multiple of a vector, a partial tile
    after whole ones, and tensors smaller than one vector."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
    _against_plain(x, "quick_gelu", max_ulps=1 if dtype == torch.bfloat16 else 2, min_equal=0.0)


def test_activation_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.zeros(64, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        activation_cuda.mlp_activation(x.t(), "quick_gelu")
    with pytest.raises(ValueError, match="16-byte aligned"):
        activation_cuda.mlp_activation(x.reshape(-1)[1:], "quick_gelu")
    with pytest.raises(ValueError, match="act must be one of"):
        activation_cuda.mlp_activation(x, "relu")
    with pytest.raises(TypeError):
        activation_cuda.mlp_activation(x.to(torch.float64), "gelu")


@pytest.mark.parametrize("dim,mlp_dim,act,t", [(1024, 4096, "quick_gelu", 577), (1152, 4304, "gelu_pytorch_tanh", 729)],
                         ids=["clip-l", "siglip"])
def test_tower_mlp_launches_the_kernel_once_a_call(dev, dim, mlp_dim, act, t):
    """A CLIP-L and a SigLIP-400M vision MLP in bf16: one launch a call, and
    the plain MLP's output (the activation bit-equal on at least 99.9%)."""
    from multimodal_embedding_tpu_torch.models.layers import MLP

    gen = torch.Generator(device=dev).manual_seed(0)
    mlp = MLP(dim, mlp_dim, act, gen=gen, device=dev, dtype=torch.bfloat16)
    x = torch.randn(2, t, dim, generator=gen, device=dev).to(torch.bfloat16)
    before = _count("mlp_activation")
    with torch.no_grad():
        for _ in range(3):
            y = mlp(x)
        torch.cuda.synchronize()
        assert _count("mlp_activation") == before + 3
        h = mlp.fc1(x)
        want_h = activation_cuda.reference(h, act)
        got_h = activation_cuda.mlp_activation(h, act)
        plain = mlp.fc2(want_h)
    assert float((got_h == want_h).double().mean()) >= 0.999
    assert y.dtype == torch.bfloat16 and _rel(y, plain.float()) <= 1e-2


@pytest.mark.parametrize("act", ACTS)
def test_activation_gradient_recomputes_through_plain_version(dev, act):
    """With an input that needs a gradient the call goes through the autograd
    Function: the same forward as the inference launch, and the gradient of
    the plain version."""
    gen = torch.Generator(device=dev).manual_seed(13)
    h0 = torch.randn(33, 520, generator=gen, device=dev) * 3
    g = torch.randn(33, 520, generator=gen, device=dev)
    with torch.no_grad():
        plain_fwd = activation_cuda.mlp_activation(h0, act)
    h = h0.clone().requires_grad_()
    y = activation_cuda.mlp_activation(h, act)
    assert y.requires_grad and torch.equal(y.detach(), plain_fwd)
    y.backward(g)
    href = h0.clone().requires_grad_()
    activation_cuda.reference(href, act).backward(g)
    assert torch.equal(h.grad, href.grad)
