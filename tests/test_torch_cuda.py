"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided in
a fixture, at run time). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: attention 1e-5 in f32 and 2e-2 in bf16
against the plain version in f32 on the same inputs; preprocess at least
99.9% bit-equal and within one quantization level.
"""

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.ops import attention_cuda
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


@pytest.mark.parametrize("h,w", [(480, 640), (640, 480), (480, 480), (427, 640)])
def test_preprocess_kernel_matches_plain(dev, h, w):
    cfg = PreprocessConfig(image_size=336)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 3, h, w), dtype=np.uint8)).to(dev)
    got = make_preprocess_cuda_fn(cfg, h, w, device=dev)(x)
    want = make_preprocess_fn(cfg, h, w, device=dev, input_format="nchw")(x)
    assert float((got == want).float().mean()) >= 0.999
    level = scale_shift(cfg)[0]
    for ch in range(3):
        assert float((got - want)[..., ch].abs().max()) <= level[ch] * (1 + 1e-5) + 1e-6
