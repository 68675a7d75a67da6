"""Kimi Delta Attention's recurrence on the card: the hand-written Hopper
kernel of ``csrc/kda.cu`` (``ops/kda.py`` has the equations and the plain
version), the recurrence token by token on the CUDA cores, each head's f32
state in registers for the whole sequence, split along v into two halves,
one block each.

:func:`kda` takes q, k, v ``[B, T, H, 128]`` in one dtype, float32 or
bfloat16, whose heads and channels are contiguous and which share
their token and sequence strides (views into one projection, as the KDA
layer's q, k and v are), g ``[B, T, H, 128]`` and beta ``[B, T, H]``
contiguous in float32. It returns o ``[B, T, H, 128]`` contiguous in q's
dtype and raises on anything the kernel does not take (another head size,
other strides or dtypes); it runs no backward. Each launch is counted in
``ops.launch_counts()`` as ``kda_scan`` and spanned as
``mme.kernel.kda_scan``. The kernel launches on the current stream into
``torch.empty`` with no host sync, so a CUDA graph can capture it.

The library is built and loaded at the first launch: only a model with KDA
layers ever builds it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # of csrc/kda.cu
HEAD_DIM = 128

_c = ctypes
_ARGTYPES = [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_longlong, _c.c_void_p,
             _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_longlong, _c.c_longlong, _c.c_void_p]
_fns: dict = {}


def _fn():
    if "kda" not in _fns:
        fn = build.load("kda").kda_scan_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fns["kda"] = fn
    return _fns["kda"]


def _check(q, k, v, g, beta) -> None:
    """Raise on inputs the kernel does not take."""
    for t in (q, k, v, g, beta):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"the KDA kernel runs on one cuda device, not {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the KDA kernel has no backward")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype or g.dtype != torch.float32 \
            or beta.dtype != torch.float32:
        raise TypeError(f"kda: q, k and v in one of float32 or bfloat16, g and beta in float32, not "
                        f"{[t.dtype for t in (q, k, v, g, beta)]}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or any(t.shape != q.shape for t in (k, v, g)) \
            or beta.shape != q.shape[:3]:
        raise ValueError(f"kda: q, k, v and g [B, T, H, {HEAD_DIM}] and beta [B, T, H], not "
                         f"{[tuple(t.shape) for t in (q, k, v, g, beta)]}")
    if q.stride(3) != 1 or q.stride(2) != HEAD_DIM or any(t.stride() != q.stride() for t in (k, v)):
        raise ValueError("kda: q, k and v need contiguous heads and channels and the same strides")
    if not (g.is_contiguous() and beta.is_contiguous()):
        raise ValueError("kda: g and beta must be contiguous")


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The recurrence on the card: o [B, T, H, 128] in q's dtype."""
    _check(q, k, v, g, beta)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel():
        with KERNELS.span("kernel.kda_scan"):
            _run(q, k, v, g, beta, o)
        KERNELS.count("kda_scan")
    return o


def _run(q, k, v, g, beta, o) -> None:
    """The kernel's launch on the current stream, raising on its error code."""
    b, t, h, _ = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(_fn()(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
                      q.stride(1), g.data_ptr(), beta.data_ptr(), o.data_ptr(), b, t, h, stream), "KDA kernel")
