"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, at run time). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: attention 1e-5 in f32 and 2e-2 in bf16
against the plain version in f32 on the same inputs; preprocess at least
99.9% bit-equal and within one quantization level; MaxSim max|d|/max|plain|
at most 1e-5 in f32 and 1e-4 in bf16 (bf16 products are exact in f32, so
only the order of the f32 sums differs), and two calls bit-equal; the prologue's x_new bit-equal to
the plain version in the same dtype and its y, and LayerNorm, within
max|d|/max|plain| 1e-5 in f32 and 1e-2 in bf16 against the plain version in
f32; the prologue's row pass alone: x_new bit-equal and h within
max|d|/max|plain| 1e-5 in f32 and 1e-2 in bf16 of the plain row pass in the
same dtype; the prologue's and LayerNorm's forwards equal with and without
the autograd Function, and LayerNorm on misaligned scale and bias views equal
to aligned copies; stacked-QKV attention bit-equal to the attention kernel on
contiguous copies of the three slices.
"""

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.ops import attention_cuda, fused_ln_matmul_cuda, layernorm_cuda, maxsim_cuda
from multimodal_embedding_tpu_torch.ops.preprocess import PreprocessConfig, make_preprocess_fn, scale_shift
from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout,h,kvh,t,dh,causal,masked", [
    ("packed", 16, 16, 577, 64, False, False),
    ("packed", 12, 12, 77, 64, True, True),
    ("bhtd", 8, 2, 100, 72, True, True),
    ("bhtd", 4, 1, 1030, 256, True, False),
    ("packed", 16, 16, 1024, 72, False, False),  # SigLIP-448 in ColPali
    ("packed", 8, 1, 1030, 256, False, False),  # Gemma over image + suffix tokens
    ("packed", 8, 1, 32, 256, False, True),  # Gemma text sweep: key mask, not causal
    # T past a 64-row query tile and a 64- or 32-key tile; each padded head
    # dim of the bf16 kernel (40 -> 64, 80, 128, 256)
    ("packed", 4, 4, 65, 40, False, True),
    ("bhtd", 4, 2, 33, 80, True, True),
    ("packed", 4, 4, 65, 128, True, False),
    ("bhtd", 4, 1, 65, 256, False, True),
    ("packed", 2, 1, 33, 256, True, True),
])
def test_attention_kernel_matches_plain(dev, dtype, tol, layout, h, kvh, t, dh, causal, masked):
    rng = np.random.default_rng(0)
    b = 2
    shapes = ([(b, t, h * dh), (b, t, kvh * dh), (b, t, kvh * dh)] if layout == "packed"
              else [(b, h, t, dh), (b, kvh, t, dh), (b, kvh, t, dh)])
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype) for s in shapes)
    km = None
    if masked:
        km = torch.from_numpy((np.arange(t)[None, :] < np.array([[t], [t // 3]])).astype(np.int32)).to(dev)
    kw = dict(causal=causal, layout=layout, num_heads=h, num_kv_heads=kvh)
    got = attention_cuda.fused_attention(q, k, v, km, **kw)
    scale = dh ** -0.5
    want = attention_cuda._plain(q.float(), k.float(), v.float(), km, causal, scale, layout, h, kvh)
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol


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


def test_attention_bf16_takes_a_long_key_row(dev):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 4096, 64), dtype=np.float32)).to(dev, torch.bfloat16)
               for _ in range(3))
    got = attention_cuda.fused_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention_cuda._plain(q.float(), k.float(), v.float(), None, False, 0.125, "bhtd", 2, 2)
    _assert_bf16_attention_close(got, want)


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
    before = maxsim_cuda.launches
    got = maxsim_cuda.maxsim_scores(q, d, qm, dm, impl="pallas")
    torch.cuda.synchronize()
    assert maxsim_cuda.launches == before + 1
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
    before = fused_ln_matmul_cuda.launches
    x_new, y = fused_ln_matmul_cuda.fused_res_norm_matmul(x, delta, gamma, beta, w, b, norm=norm, act=act)
    torch.cuda.synchronize()
    assert fused_ln_matmul_cuda.launches == before + 1
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
    before = fused_ln_matmul_cuda.row_launches
    x_new, h = fused_ln_matmul_cuda.fused_res_norm_rows(x, delta, gamma, beta, norm=norm, eps=1e-6)
    torch.cuda.synchronize()
    assert fused_ln_matmul_cuda.row_launches == before + 1
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
])
def test_attention_qkv_kernel_equals_attention_on_copies(dev, dtype, h, kvh, t, dh, causal, masked):
    rng = np.random.default_rng(6)
    b = 2
    qkv = torch.from_numpy(rng.standard_normal((b, t, (h + 2 * kvh) * dh), dtype=np.float32)).to(dev, dtype)
    km = None
    if masked:
        km = torch.from_numpy((np.arange(t)[None, :] < np.array([[t], [t // 3]])).astype(np.int32)).to(dev)
    before = attention_cuda.qkv_launches
    got = attention_cuda.fused_attention_qkv(qkv, km, causal=causal, num_heads=h, num_kv_heads=kvh)
    assert attention_cuda.qkv_launches == before + 1
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
    before = layernorm_cuda.launches
    got = layernorm_cuda.fused_layer_norm(x, s, b, eps=1e-6)
    torch.cuda.synchronize()
    assert layernorm_cuda.launches == before + 1
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
