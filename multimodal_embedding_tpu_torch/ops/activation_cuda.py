"""The towers' MLP activation: the hand-written Hopper kernel
(``csrc/activation.cu``) and its plain PyTorch version.

Counterpart of the activation line of ``multimodal_embedding_tpu/models/
layers.py:MLP`` (``ACTIVATIONS[act](h.astype(f32)).astype(x.dtype)``), which
XLA fuses into one elementwise pass; no Pallas kernel does it. Both versions
widen ``h`` to f32, apply the activation in f32 and round once to h's dtype.
The plain version runs that line as separate PyTorch ops (in bf16: five
launches for quick_gelu, three for the GELUs); the kernel is one pass.

:func:`mlp_activation` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it takes the plain version only for
tensors that lie on the CPU. The gradient recomputes through the plain
version; a call that needs no gradient skips the autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build

# f32 in, f32 out: the JAX package's ACTIVATIONS
ACTIVATIONS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_pytorch_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}
ACT_CODES = {"gelu": 1, "quick_gelu": 2, "gelu_pytorch_tanh": 3}  # of csrc/activation.cu and fused_ln_matmul.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_c = ctypes
_ARGTYPES = [_c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_void_p]
_fwd = None  # the C entry point, typed once


def _activation_fwd():
    global _fwd
    if _fwd is None:
        fn = build.load("activation").mlp_activation_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fwd = fn
    return _fwd


def reference(h: torch.Tensor, act: str) -> torch.Tensor:
    """The plain version: ``act`` in f32, one rounding to h's dtype."""
    return ACTIVATIONS[act](h.float()).to(h.dtype)


def _launch(h, act):
    with KERNELS.span("kernel.mlp_activation"):
        y = _run(h, act)
    if h.numel():
        KERNELS.count("mlp_activation")
    return y


def _run(h, act):
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"activation kernel takes float32, bfloat16 or float16, not {h.dtype}")
    if not h.is_contiguous():
        raise ValueError("activation kernel needs a contiguous tensor")
    if h.data_ptr() % 16:
        raise ValueError("activation kernel needs a 16-byte aligned tensor")
    y = torch.empty_like(h, memory_format=torch.contiguous_format)
    if h.numel():
        code = _activation_fwd()(_DTYPE_CODES[h.dtype], ACT_CODES[act], h.data_ptr(), y.data_ptr(), h.numel(),
                                 torch.cuda.current_stream(h.device).cuda_stream)
        build.check(code, "activation kernel")
    return y


class _MLPActivation(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, h, act):
        ctx.save_for_backward(h)
        ctx.act = act
        return _launch(h, act)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        with torch.enable_grad():
            hi = h.detach().requires_grad_()
            (gh,) = torch.autograd.grad(reference(hi, ctx.act), hi, g)
        return gh, None


def mlp_activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """``act(h)`` in h's dtype, computed in f32: h ``[..., N]`` in bfloat16,
    float16 or float32; ``act`` one of :data:`ACTIVATIONS`."""
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {tuple(ACTIVATIONS)}, not {act!r}")
    if h.device.type == "cpu":
        return reference(h, act)
    if h.device.type != "cuda":
        raise ValueError(f"mlp_activation runs on cuda (kernel) or cpu (plain), not {h.device}")
    if torch.is_grad_enabled() and h.requires_grad:
        return _MLPActivation.apply(h, act)
    return _launch(h, act)  # inference: no autograd Function
