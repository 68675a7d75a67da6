"""The port's attention against the JAX package's, on the CPU.

The port's ``fused_attention`` takes its plain version for CPU tensors; it
is held against the JAX Pallas kernel run in interpret mode (as
tests/test_attention_pallas.py runs it), in both layouts, with causal and
key masks, grouped-query heads, a multi-q-block length and fully masked
rows. Tolerances: 1e-5 in f32 (summation order), 2e-2 in bf16 (one bf16
rounding of probabilities and outputs). The port's "xla"/"xla_bf16"
``attention_core`` is held against the JAX one. The f32 kernel's arithmetic
(3xTF32 products, ``tests/torch_tf32.py``) is held against JAX's f32
reference at small versions of the f32 paths' shapes. The rule that sends a
bf16 launch at Dh <= 80 to the kernel's warpgroup body, and the count that
follows it, are checked here; the kernel itself only on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tf32

from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.ops.attention_pallas import _sdpa_reference
from multimodal_embedding_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from multimodal_embedding_tpu_torch import ops, runtime
from multimodal_embedding_tpu_torch.models import layers as tlayers
from multimodal_embedding_tpu_torch.ops import attention_cuda
from multimodal_embedding_tpu_torch.ops.attention_cuda import fused_attention
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS
from tests.torch_impls import impl  # noqa: F401  (the parametrized attention switch)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(rng, b, h, kvh, tq, tk, dh, layout, masked, dtype):
    if layout == "packed":
        shapes = [(b, tq, h * dh), (b, tk, kvh * dh), (b, tk, kvh * dh)]
    else:
        shapes = [(b, h, tq, dh), (b, kvh, tk, dh), (b, kvh, tk, dh)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    km = None
    if masked:
        km = (rng.random((b, tk)) < 0.8).astype(np.int32)
        km[:, 0] = 1  # keep every row attendable
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a).astype(jd) for a in arrs]
    tx = [torch.from_numpy(a).to(td) for a in arrs]
    return jx, tx, km


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kvh,tq,tk,dh,causal,masked,layout",
    [
        (2, 4, 4, 37, 37, 64, False, False, "bhtd"),
        (2, 4, 4, 37, 37, 64, False, True, "bhtd"),
        (1, 4, 4, 33, 33, 64, True, True, "bhtd"),
        (2, 8, 1, 29, 29, 32, False, True, "bhtd"),  # MQA
        (2, 8, 2, 19, 19, 32, True, False, "bhtd"),  # grouped-query causal
        (2, 2, 2, 9, 41, 16, False, True, "bhtd"),  # cross attention
        (1, 2, 2, 200, 200, 64, False, False, "bhtd"),  # several query blocks
        (2, 4, 4, 37, 37, 64, True, True, "packed"),
        (2, 2, 2, 77, 77, 64, False, False, "packed"),
        # Qwen3-14B's grouping (40 query heads over 8 KV heads, Dh 128) cut to 10 over 2
        (2, 10, 2, 24, 24, 128, True, True, "packed"),
        (1, 10, 2, 40, 40, 128, True, False, "bhtd"),
    ],
)
def test_plain_matches_jax_kernel(b, h, kvh, tq, tk, dh, causal, masked, layout, dtype):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq_, tk_, tv), km = _inputs(rng, b, h, kvh, tq, tk, dh, layout, masked, dtype)
    kw = dict(causal=causal, layout=layout)
    if layout == "packed":
        kw.update(num_heads=h, num_kv_heads=kvh if kvh != h else None)
    want = jax_fused_attention(
        jq, jk, jv, key_mask=None if km is None else jnp.asarray(km),
        block_q=64 if tq >= 200 else None, interpret=True, **kw,
    )
    got = fused_attention(tq_, tk_, tv, None if km is None else torch.from_numpy(km), **kw)
    assert got.dtype == tq_.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=TOL[dtype], rtol=0
    )


@pytest.mark.parametrize("layout", ["bhtd", "packed"])
def test_fully_masked_rows_are_exact_zeros(layout):
    rng = np.random.default_rng(1)
    b, h, t, dh = 2, 2, 16, 64
    (jq, jk, jv), (tq_, tk_, tv), _ = _inputs(rng, b, h, h, t, t, dh, layout, False, "float32")
    km = np.ones((b, t), np.int32)
    km[1] = 0  # every row of sequence 1
    km[0, 0] = 0  # with causal: row 0 of sequence 0
    kw = dict(causal=True, layout=layout, num_heads=h if layout == "packed" else None)
    want = jax_fused_attention(jq, jk, jv, key_mask=jnp.asarray(km), interpret=True, **kw)
    got = fused_attention(tq_, tk_, tv, torch.from_numpy(km), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    g4 = got if layout == "bhtd" else got.reshape(b, t, h, dh).transpose(1, 2)
    assert bool((g4[1] == 0).all()) and bool((g4[0, :, 0] == 0).all())


def test_plain_version_is_differentiable():
    """The JAX kernel's custom_vjp recomputes through _sdpa_reference; the
    port's plain version is the same function, so autograd through it gives
    the JAX gradient."""
    rng = np.random.default_rng(2)
    (jq, jk, jv), (tq_, tk_, tv), km = _inputs(rng, 1, 2, 2, 12, 12, 16, "bhtd", True, "float32")
    jkm = jnp.asarray(km)

    def jloss(q, k, v):
        return jnp.sum(jax_fused_attention(q, k, v, key_mask=jkm, causal=True, interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    xs = [x.clone().requires_grad_() for x in (tq_, tk_, tv)]
    (fused_attention(*xs, torch.from_numpy(km), causal=True) ** 2).sum().backward()
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,dh,wgmma", [
    (torch.bfloat16, 8, True), (torch.bfloat16, 40, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 72, True), (torch.bfloat16, 80, True), (torch.bfloat16, 88, False),
    (torch.bfloat16, 128, False), (torch.bfloat16, 192, False), (torch.bfloat16, 256, False),
    (torch.float32, 64, False), (torch.float32, 128, False),
])
def test_head_dim_alone_picks_the_warpgroup_body(dtype, dh, wgmma):
    assert attention_cuda.uses_wgmma(dtype, dh) is wgmma


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [40, 64, 72, 80, 128, 256])
def test_warpgroup_launches_are_counted_by_head_dim(monkeypatch, dtype, dh):
    """One launch of each wrapper (the kernel call replaced: no card here):
    ``fused_attention_wgmma`` counts both at bf16 Dh <= 80 and neither
    otherwise; the totals count each launch once."""
    monkeypatch.setattr(KERNELS, "counts", {})
    monkeypatch.setattr(attention_cuda, "_run", lambda q, *args: q)
    h = 2
    attention_cuda._launch(torch.zeros(1, 3, h * dh, dtype=dtype), None, None, None, False, 1.0, "packed", h, h)
    attention_cuda._launch(torch.zeros(1, h, 3, dh, dtype=dtype), None, None, None, False, 1.0, "bhtd", h, h)
    attention_cuda._launch_qkv(torch.zeros(1, 3, 3 * h * dh, dtype=dtype), None, False, 1.0, h, h)
    counts = ops.launch_counts()
    bf16 = dtype == torch.bfloat16
    assert counts["fused_attention" if bf16 else "fused_attention_f32"] == 2
    assert counts["fused_attention_qkv"] == 1
    assert counts["fused_attention_wgmma"] == (3 if bf16 and dh <= 80 else 0)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 10, 3 * 8)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, layout="packed")  # no num_heads
    with pytest.raises(ValueError):
        fused_attention(q, q, q, layout="packed", num_heads=3, num_kv_heads=2)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, layout="nhwc")


@pytest.mark.parametrize("impl,dtype", [("xla", "float32"), ("xla_bf16", "bfloat16"), ("pallas", "float32")],
                         indirect=["impl"])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_attention_core_matches_jax(impl, dtype, causal, masked):
    rng = np.random.default_rng(3)
    b, t, h, dh = 2, 21, 4, 16
    arrs = [rng.standard_normal((b, t, h * dh)).astype(np.float32) for _ in range(3)]
    km = None
    if masked:
        km = (rng.random((b, t)) < 0.7).astype(np.int32)
        km[:, 0] = 1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jlayers.attention_core(
        *[jnp.asarray(a).astype(jd) for a in arrs], h, causal=causal,
        mask=None if km is None else jnp.asarray(km),
    )
    got = tlayers.attention_core(
        *[torch.from_numpy(a).to(td) for a in arrs], h, causal=causal,
        mask=None if km is None else torch.from_numpy(km),
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=TOL[dtype], rtol=0
    )


def test_unported_attention_impl_raises():
    # every impl of the JAX package is ported, "flash" included; an
    # unknown name still raises
    with runtime.using(attention="flash"):
        assert runtime.attention_impl("cpu") == "flash"
    with pytest.raises(ValueError), runtime.using(attention="nope"):
        pass


# Small versions of the f32 paths' shapes: the small Qwen3's heads (8 over 4,
# Dh 64), Qwen3-14B's grouping cut to 10 over 2 (Dh 128), one KV head at Dh
# 256 (the small Gemma's head dim); causal with left padding, the last
# sequence mostly padding (its pad query rows fully masked)
F32_EMULATION_SHAPES = [(2, 8, 4, 96, 64), (2, 10, 2, 80, 128), (2, 2, 1, 48, 256)]


@pytest.mark.parametrize("rounding", ["rne", "kernel"])
@pytest.mark.parametrize("b,h,kvh,t,dh", F32_EMULATION_SHAPES)
def test_3xtf32_emulation_holds_jax_reference(rounding, b, h, kvh, t, dh):
    """The f32 kernel's products, 3xTF32 emulated in numpy under round to
    nearest even and under the kernel's own rounding, through the attention
    core hold JAX's f32 ``_sdpa_reference`` within max|d|/max|plain| 3e-6, a
    margin under the card's 1e-5 gate; one TF32 pass does not hold 1e-5."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, t, dh), dtype=np.float32)
    k, v = (rng.standard_normal((b, kvh, t, dh), dtype=np.float32) for _ in range(2))
    lengths = rng.integers(3, t + 1, size=b)
    lengths[-1] = t // 3
    km = (np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)
    scale = dh ** -0.5
    want = np.asarray(_sdpa_reference(*(jnp.asarray(x) for x in (q, k, v, km)), causal=True, sm_scale=scale))

    def rel(passes):
        got = torch_tf32.attention(q, k, v, km, causal=True, scale=scale, rounding=rounding, passes=passes)
        return float(np.abs(got - want).max() / np.abs(want).max())

    assert rel(3) <= 3e-6
    assert rel(1) > 1e-5
