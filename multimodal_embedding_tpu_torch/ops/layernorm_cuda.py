"""Row LayerNorm: the hand-written Hopper kernel (``csrc/layernorm.cu``) and
its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/layernorm_pallas.py:
fused_layer_norm``: f32 mean, then the variance as ``mean((x - mu)^2)`` in
f32, scale and shift in f32, one rounding to x's dtype. As in the JAX
package, nothing routes it: the towers take ``F.layer_norm``
(``models/layers.py:layer_norm``) and the fused prologue normalizes in its
own row pass. It stays a tested, differentiable function.

:func:`fused_layer_norm` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version only for
tensors that lie on the CPU. The gradient recomputes through the plain
version (the JAX kernel's ``custom_vjp`` design); a call that needs no
gradient skips the autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build

_c = ctypes
_ARGTYPES = [_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int, _c.c_int, _c.c_float, _c.c_int, _c.c_void_p]
_fwd = None  # the C entry point, typed once


def _layernorm_fwd():
    global _fwd
    if _fwd is None:
        fn = build.load("layernorm").layernorm_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fwd = fn
    return _fwd


def reference(x, scale, bias, *, eps: float = 1e-5) -> torch.Tensor:
    """The plain version (``layernorm_pallas``'s ``ref_ln``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _launch(x, scale, bias, eps):
    with KERNELS.span("kernel.fused_layer_norm"):
        return _run(x, scale, bias, eps)


def _run(x, scale, bias, eps):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layernorm kernel takes bfloat16 or float32, not {x.dtype}")
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != x.dtype or v.device != x.device:
            raise ValueError(f"{name} must match x's dtype and device")
    d = x.shape[-1]
    if d % 8:
        raise ValueError(f"layernorm kernel takes a row width that is a multiple of 8, not {d}")
    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    if x2.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("layernorm kernel needs 16-byte aligned rows")
    scale, bias = scale.contiguous(), bias.contiguous()
    sb_vec = int(scale.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0)  # else element loads
    code = _layernorm_fwd()(
        1 if x.dtype == torch.bfloat16 else 0, x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x2.shape[0], d, float(eps), sb_vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "layernorm kernel")
    KERNELS.count("fused_layer_norm")
    return y.reshape(x.shape)


class _FusedLayerNorm(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _launch(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(reference(*ins, eps=ctx.eps), ins, g)
        return (*grads, None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` ([..., D]); scale, bias [D]."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"scale and bias must be [{d}], not {tuple(scale.shape)}, {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return reference(x, scale, bias, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm runs on cuda (kernel) or cpu (plain), not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, float(eps))
    return _launch(x, scale, bias, float(eps))  # inference: no autograd Function
