"""Fused softmax attention: the hand-written Hopper kernel
(``csrc/attention.cu``) and its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/attention_pallas.py:
fused_attention``. Semantics of both versions: f32 QK^T, finite ``-1e30``
masking of invalid keys (key mask and/or causal), f32 softmax against the
whole key row, probabilities cast to V's dtype before an f32-accumulated PV,
the softmax denominator applied after PV, exact zeros for a fully masked row,
and grouped-query attention with KVH | H.

:func:`fused_attention` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version
(:func:`sdpa_reference`) only for tensors that lie on the CPU. Like the JAX
kernel's ``custom_vjp``, the gradient recomputes through the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

# Kernel launches made by fused_attention (a plain count, read by chip_smoke.py).
launches = 0

_c = ctypes
_ARGTYPES = (
    [_c.c_int] + [_c.c_void_p] * 5 + [_c.c_int] * 6 + [_c.c_longlong] * 13
    + [_c.c_int, _c.c_float, _c.c_void_p]
)


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


def _launch(q, k, v, km, causal, sm_scale, layout, h, kvh) -> torch.Tensor:
    global launches
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
    lib = build.load("attention")
    fn = lib.attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        1 if q.dtype == torch.bfloat16 else 0,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km32 is None else km32.data_ptr(), out.data_ptr(),
        b, h, kvh, tq, tk, dh,
        *_token_head_strides(q, layout, dh), *_token_head_strides(k, layout, dh),
        *_token_head_strides(v, layout, dh), *_token_head_strides(out, layout, dh),
        0 if km32 is None else km32.stride(0),
        int(causal), float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "attention kernel")
    launches += 1
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
    return _FusedAttention.apply(q, k, v, key_mask, causal, float(sm_scale), layout, h, kvh)
