"""Mamba-2's state-space scan on the card: the hand-written Hopper kernel of
``csrc/ssm.cu``, each head's f32 state in registers for the whole sequence
(``ops/ssm.py`` has the equations and the plain version). The inputs' dtype
alone picks one of the kernel's two bodies (:func:`uses_chunked`, the only
place the rule lives): bf16 runs the chunked (SSD) body, chunks of 64 tokens
whose products are ``wgmma`` warpgroup products, every operand the kernel
builds in f32 split into two bf16 terms; f32 runs the recurrent body, the
recurrence token by token on the CUDA cores.

:func:`scan` takes x ``[B, T, H, P]`` whose heads and channels are
contiguous (a view into the conv's output, read through its token stride),
dt ``[B, T, H]`` contiguous, B and C ``[B, T, N]`` with contiguous state
columns (views too), A ``[H]`` in f32 and D ``[H]``; x, dt, B, C and D in
one dtype, float32 or bfloat16. It returns y ``[B, T, H, P]`` contiguous in
that dtype and raises on anything the kernel does not take (a head dim above
128, a state size other than 16, 32, 64 or 128, other strides); it runs no
backward. Each launch is counted in ``ops.launch_counts()`` as ``ssm_scan``,
a launch of the chunked body also as ``ssm_scan_chunked``, and spanned as
``mme.kernel.ssm_scan``. The kernel launches on the current stream into
``torch.empty`` with no host sync, so a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # of csrc/ssm.cu
STATE_SIZES = (16, 32, 64, 128)
MAX_HEAD_DIM = 128

_c = ctypes
_ARGTYPES = [_c.c_int, _c.c_void_p, _c.c_longlong, _c.c_longlong, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
             _c.c_longlong, _c.c_longlong, _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_longlong, _c.c_longlong,
             _c.c_longlong, _c.c_longlong, _c.c_void_p]
_fns: dict = {}


def uses_chunked(dtype: torch.dtype) -> bool:
    """Whether a launch in ``dtype`` runs the kernel's chunked body: bf16
    does, f32 keeps the recurrent body. The kernel makes the same choice from
    the dtype code it is passed, and the launch counts it, so the two never
    disagree."""
    return dtype == torch.bfloat16


def _fn():
    if "scan" not in _fns:
        fn = build.load("ssm").ssm_scan_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _fns["scan"] = fn
    return _fns["scan"]


def _check(x, dt, A, B, C, D) -> None:
    """Raise on inputs the kernel does not take."""
    for t in (x, dt, A, B, C, D):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the scan kernel runs on one cuda device, not {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the scan kernel has no backward")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, B, C, D)) or A.dtype != torch.float32:
        raise TypeError(f"scan: x, dt, B, C and D in one of float32 or bfloat16 and A in float32, not "
                        f"{[t.dtype for t in (x, dt, B, C, D, A)]}")
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"scan: x [B, T, H, P], dt [B, T, H], B and C [B, T, N], not {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, t, h, p = x.shape
    if dt.shape != (b, t, h) or B.shape[:2] != (b, t) or A.shape != (h,) or D.shape != (h,):
        raise ValueError("scan: the shapes of x, dt, A, B, C and D disagree")
    if not 1 <= p <= MAX_HEAD_DIM or B.shape[2] not in STATE_SIZES:
        raise ValueError(f"scan: head dim {p} (1 to {MAX_HEAD_DIM}) and state size {B.shape[2]} {STATE_SIZES}")
    if x.stride(3) != 1 or x.stride(2) != p or not dt.is_contiguous() or not A.is_contiguous() \
            or not D.is_contiguous():
        raise ValueError("scan: x's heads and channels, dt, A and D must be contiguous")
    if B.stride(2) != 1 or C.stride(2) != 1 or B.stride()[:2] != C.stride()[:2]:
        raise ValueError("scan: B and C need contiguous state columns and the same strides")


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
         D: torch.Tensor) -> torch.Tensor:
    """The scan on the card: y [B, T, H, P] in x's dtype."""
    _check(x, dt, A, B, C, D)
    b, t, h, p = x.shape
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    if y.numel():
        with KERNELS.span("kernel.ssm_scan"):
            _run(x, dt, A, B, C, D, y)
        KERNELS.count("ssm_scan")
        if uses_chunked(x.dtype):
            KERNELS.count("ssm_scan_chunked")
    return y


def _run(x, dt, A, B, C, D, y) -> None:
    """The kernel's launch on the current stream, raising on its error code."""
    b, t, h, p = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(_fn()(_DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(), B.stride(0), B.stride(1), D.data_ptr(), y.data_ptr(), b, t, h, p,
                      B.shape[2], stream), "state-space scan kernel")
