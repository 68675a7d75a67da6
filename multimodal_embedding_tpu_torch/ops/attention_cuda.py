"""Fused softmax attention: the hand-written Hopper kernel
(``csrc/attention.cu``) and its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/attention_pallas.py:
fused_attention`` and ``fused_attention_qkv`` (the same kernel reading q, k
and v out of one stacked projection). Semantics of both versions: f32 QK^T, finite ``-1e30``
masking of invalid keys (key mask and/or causal), f32 softmax against the
whole key row, probabilities cast to V's dtype before an f32-accumulated PV,
the softmax denominator applied after PV, exact zeros for a fully masked row,
and grouped-query attention with KVH | H.

Where the kernel keeps its logits: in registers, in both dtypes. A block
takes 64 or 128 query rows and sweeps the key tiles twice (the row max, then
p, its sum and PV), so its shared memory holds Q and K/V rings and does not
grow with Tk; any key row length is taken. In bf16 the head dim alone picks
one of two bodies of the one ``flash_kernel`` (:func:`uses_wgmma`, the only
place the rule lives). Up to :data:`WGMMA_MAX_HEAD_DIM` (CLIP, SigLIP,
ViT-H, ColPali's SigLIP-448) both products are ``wgmma`` warpgroup
products, QK^T from shared memory and PV with p in registers, fed by
``cp.async`` rings of 64-key tiles in the layouts ``wgmma`` reads; a block
has two warpgroups on 128 rows sharing each tile, or one on 64 where a
head's rows fit in 64; a launch also counts as ``fused_attention_wgmma``.
Above it (Qwen3, Gemma, Kimi's MLA) the products are ``mma.sync`` on 32-key
tiles. ``wgmma`` changes where the products run, not the rounding: f32
QK^T, p in f32 against the exact row max, rounded to bf16 once, PV in f32.
Still left: TMA with a producer warp, overlapping one warpgroup's softmax
with another's products, and one QK^T pass in place of two. Registers and
spills per template: PERF.md's kernel table. In f32 every product is three
TF32 tensor-core products of split operands (3xTF32, within about 2^-21 of
f32 a product) and p stays f32. The f32 kernel serves Workload B's f32
models: ``cli/train_rl.py`` and ``cli/verify_rl.py`` at their default
``--model-size small``, a ``--save-base`` base read back by
``--base-params``, and ``dryrun_multichip``.

:func:`fused_attention` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version
(:func:`sdpa_reference`) only for tensors that lie on the CPU. Like the JAX
kernel's ``custom_vjp``, the gradient recomputes through the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.profiling import KERNELS
from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
WGMMA_MAX_HEAD_DIM = 80  # bf16 head dims up to this take the warpgroup body

# the C entry point's body argument
_BODY_F32, _BODY_MMA, _BODY_WGMMA = 0, 1, 2

_c = ctypes
_ARGTYPES = (
    [_c.c_int] + [_c.c_void_p] * 5 + [_c.c_int] * 6 + [_c.c_longlong] * 13
    + [_c.c_int, _c.c_float, _c.c_void_p]
)
_fwd = None  # the C entry point, typed once


def _attention_fwd():
    global _fwd
    if _fwd is None:
        fn = build.load("attention").attention_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fwd = fn
    return _fwd


def sdpa_reference(q, k, v, km, *, causal: bool, sm_scale: float) -> torch.Tensor:
    """The plain version, ``[B, H, Tq, Dh]`` layout; k, v ``[B, KVH, Tk, Dh]``.

    A port of ``attention_pallas._sdpa_reference``: f32 logits, finite
    masking, f32 softmax, fully masked rows zeroed, probabilities cast to V's
    dtype, f32-accumulated PV. Returns q's dtype."""
    b, h, tq, _ = q.shape
    kvh, tk = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    valid = None
    if km is not None:
        valid = km[:, None, None, :].bool().expand(logits.shape)
    if causal:
        cm = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        valid = cm.expand(logits.shape) if valid is None else valid & cm
    if valid is not None:
        logits = logits.masked_fill(~valid, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    if valid is not None:
        attn = attn * valid.float().amax(dim=-1, keepdim=True)
    attn = attn.to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float())
    return out.to(q.dtype)


def uses_wgmma(dtype: torch.dtype, dh: int) -> bool:
    """Whether a launch at head dim ``dh`` runs the kernel's warpgroup
    (``wgmma``) body: bf16 up to :data:`WGMMA_MAX_HEAD_DIM` (padded to 64 or
    80). The launch passes this choice to the kernel and counts it, so the
    two never disagree."""
    return dtype == torch.bfloat16 and dh <= WGMMA_MAX_HEAD_DIM


def _to_bhtd(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, t, hd = x.shape
    return x.reshape(b, t, nh, hd // nh).transpose(1, 2)


def _plain(q, k, v, km, causal, sm_scale, layout, h, kvh):
    if layout == "packed":
        o = sdpa_reference(
            _to_bhtd(q, h), _to_bhtd(k, kvh), _to_bhtd(v, kvh), km,
            causal=causal, sm_scale=sm_scale,
        )
        return o.transpose(1, 2).reshape(q.shape)
    return sdpa_reference(q, k, v, km, causal=causal, sm_scale=sm_scale)


def _geometry(q, k, v, layout, num_heads, num_kv_heads):
    """(B, H, KVH, Tq, Tk, Dh) from the operands of either layout."""
    if layout == "packed":
        if num_heads is None:
            raise ValueError("packed layout needs num_heads")
        b, tq, hd = q.shape
        h = num_heads
        kvh = h if num_kv_heads is None else num_kv_heads
        dh = hd // h
        if hd != h * dh or k.shape[-1] != kvh * dh or v.shape != k.shape:
            raise ValueError(f"packed shapes {tuple(q.shape)}, {tuple(k.shape)} for {h}/{kvh} heads")
        tk = k.shape[1]
    elif layout == "bhtd":
        b, h, tq, dh = q.shape
        _, kvh, tk, _ = k.shape
        if v.shape != k.shape or k.shape[3] != dh:
            raise ValueError(f"bhtd shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    else:
        raise ValueError(f"layout must be 'bhtd' or 'packed', not {layout!r}")
    if h % kvh:
        raise ValueError(f"kv heads {kvh} must divide heads {h}")
    return b, h, kvh, tq, tk, dh


def _token_head_strides(x: torch.Tensor, layout: str, dh: int) -> tuple[int, int, int]:
    """(batch, token, head) element strides."""
    if layout == "packed":
        return x.stride(0), x.stride(1), dh
    return x.stride(0), x.stride(2), x.stride(1)


def _run(q, k, v, km, causal, sm_scale, layout, h, kvh) -> torch.Tensor:
    """Launch the kernel (uncounted: each caller counts its own launches)."""
    b, _, _, tq, tk, dh = _geometry(q, k, v, layout, h, kvh)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bfloat16 or float32, not {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes a head dim that is a multiple of 8 up to 256, not {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim")
        if any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned rows (strides multiple of 8 elements)")
    km32 = None
    if km is not None:
        if tuple(km.shape) != (b, tk) or km.device != q.device:
            raise ValueError(f"key_mask must be [B, Tk] = {(b, tk)} on q's device")
        km32 = km.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        body = _BODY_F32
    else:
        body = _BODY_WGMMA if uses_wgmma(q.dtype, dh) else _BODY_MMA
    code = _attention_fwd()(
        body,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km32 is None else km32.data_ptr(), out.data_ptr(),
        b, h, kvh, tq, tk, dh,
        *_token_head_strides(q, layout, dh), *_token_head_strides(k, layout, dh),
        *_token_head_strides(v, layout, dh), *_token_head_strides(out, layout, dh),
        0 if km32 is None else km32.stride(0),
        int(causal), float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "attention kernel")
    return out


def _needs_grad(*xs: torch.Tensor) -> bool:
    """Whether autograd must record the call; inference skips the autograd
    Function and its host time."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _count_wgmma(dtype: torch.dtype, dh: int) -> None:
    """A launch of the warpgroup body also counts as ``fused_attention_wgmma``."""
    if uses_wgmma(dtype, dh):
        KERNELS.count("fused_attention_wgmma")


def _launch(q, k, v, km, causal, sm_scale, layout, h, kvh) -> torch.Tensor:
    with KERNELS.span("kernel.fused_attention"):
        out = _run(q, k, v, km, causal, sm_scale, layout, h, kvh)
    KERNELS.count("fused_attention_f32" if out.dtype == torch.float32 else "fused_attention")
    _count_wgmma(q.dtype, q.shape[-1] // h if layout == "packed" else q.shape[-1])
    return out


class _FusedAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version (the
    JAX kernel's custom_vjp design: no logits are saved)."""

    @staticmethod
    def forward(ctx, q, k, v, km, causal, sm_scale, layout, h, kvh):
        ctx.save_for_backward(q, k, v, km)
        ctx.args = (causal, sm_scale, layout, h, kvh)
        return _launch(q, k, v, km, causal, sm_scale, layout, h, kvh)

    @staticmethod
    def backward(ctx, g):
        q, k, v, km = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = _plain(*qkv, km, *ctx.args)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None, None, None, None, None)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    layout: str = "bhtd",
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
) -> torch.Tensor:
    """Fused attention. layout "bhtd": q [B, H, Tq, Dh]; k, v [B, KVH, Tk, Dh]
    with KVH | H. layout "packed": q [B, Tq, H*Dh], k, v [B, Tk, KVH*Dh] with
    ``num_heads`` (and ``num_kv_heads`` for grouped-query) given, the raw
    projection output read in place. key_mask [B, Tk] bool/int (nonzero =
    attend). Returns q's layout and dtype."""
    _, h, kvh, _, _, dh = _geometry(q, k, v, layout, num_heads, num_kv_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    if q.device.type == "cpu":
        return _plain(q, k, v, key_mask, causal, sm_scale, layout, h, kvh)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda (kernel) or cpu (plain), not {q.device}")
    if _needs_grad(q, k, v):
        return _FusedAttention.apply(q, k, v, key_mask, causal, float(sm_scale), layout, h, kvh)
    return _launch(q, k, v, key_mask, causal, float(sm_scale), layout, h, kvh)


def _split_qkv(qkv: torch.Tensor, h: int, kvh: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views of q, k and v inside a stacked [B, T, (H + 2*KVH)*Dh] projection:
    column offsets 0, H*Dh and (H + KVH)*Dh, token stride (H + 2*KVH)*Dh."""
    dh = qkv.shape[-1] // (h + 2 * kvh)
    return qkv[..., : h * dh], qkv[..., h * dh : (h + kvh) * dh], qkv[..., (h + kvh) * dh :]


def _plain_qkv(qkv, km, causal, sm_scale, h, kvh):
    return _plain(*_split_qkv(qkv, h, kvh), km, causal, sm_scale, "packed", h, kvh)


def _launch_qkv(qkv, km, causal, sm_scale, h, kvh) -> torch.Tensor:
    with KERNELS.span("kernel.fused_attention_qkv"):
        out = _run(*_split_qkv(qkv, h, kvh), km, causal, sm_scale, "packed", h, kvh)
    KERNELS.count("fused_attention_qkv")
    _count_wgmma(qkv.dtype, qkv.shape[-1] // (h + 2 * kvh))
    return out


class _FusedAttentionQKV(torch.autograd.Function):
    """The kernel on three views of the stacked projection (no copy); the
    backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, qkv, km, causal, sm_scale, h, kvh):
        ctx.save_for_backward(qkv, km)
        ctx.args = (causal, sm_scale, h, kvh)
        return _launch_qkv(qkv, km, causal, sm_scale, h, kvh)

    @staticmethod
    def backward(ctx, g):
        qkv, km = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            (grad,) = torch.autograd.grad(_plain_qkv(x, km, *ctx.args), x, g)
        return grad, None, None, None, None, None


def fused_attention_qkv(
    qkv: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    num_heads: int,
    num_kv_heads: int | None = None,
) -> torch.Tensor:
    """Self-attention over a stacked projection ``qkv`` [B, T, (H + 2*KVH)*Dh]
    (the prologue kernel's q|k|v column concat), read in place through three
    strided views. key_mask [B, T] (nonzero = attend). Returns [B, T, H*Dh]
    in qkv's dtype; numerics of ``fused_attention(layout="packed")``."""
    h = num_heads
    kvh = h if num_kv_heads is None else num_kv_heads
    if qkv.dim() != 3 or qkv.shape[-1] % (h + 2 * kvh):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not a stacked projection of {h}/{kvh} heads")
    dh = qkv.shape[-1] // (h + 2 * kvh)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    if qkv.device.type == "cpu":
        return _plain_qkv(qkv, key_mask, causal, sm_scale, h, kvh)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention_qkv runs on cuda (kernel) or cpu (plain), not {qkv.device}")
    if _needs_grad(qkv):
        return _FusedAttentionQKV.apply(qkv, key_mask, causal, float(sm_scale), h, kvh)
    return _launch_qkv(qkv, key_mask, causal, float(sm_scale), h, kvh)
