"""The MoE layer's two elementwise passes on the card: the hand-written Hopper
kernels of ``csrc/moe.cu``.

- :func:`swiglu`: ``[..., 2I]`` gate|up -> ``silu(gate) * up``, ``[..., I]``,
  f32 math and one rounding, bit for bit the plain composition
  (``ops/moe.py:swiglu_plain``);
- :func:`combine`: each token's k sorted expert rows read through
  ``Routing.rows``, weighted and summed in f32 in choice order, rounded, and
  the shared experts' output added where given (``ops/moe.py:combine_plain``
  sums the choices in ATen's order: one step of the dtype apart at most).

Both take float32 or bfloat16 tensors and raise on anything else the kernels
do not take (dtype, contiguity, 16-byte alignment, a width that is not a
whole number of 16-byte vectors, more than 16 choices); they run no backward.
``ops/moe.py`` sends CUDA tensors here and keeps the plain versions for CPU
tensors. Each launch is counted in ``ops.launch_counts()`` as ``moe_swiglu``
or ``moe_combine`` and spanned as ``mme.kernel.moe_swiglu`` or
``mme.kernel.moe_combine``. The kernels launch on the current stream with
outputs from ``torch.empty`` and no host sync, so a CUDA graph can capture
them.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # of csrc/moe.cu
MAX_CHOICES = 16

_c = ctypes
_SIGNATURES = {
    "moe_swiglu_fwd": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_longlong, _c.c_void_p],
    "moe_combine_fwd": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                        _c.c_longlong, _c.c_longlong, _c.c_longlong, _c.c_void_p],
}
_fns: dict = {}  # the C entry points by name, typed once


def _fn(name: str):
    if name not in _fns:
        fn = getattr(build.load("moe"), name)
        fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(t: torch.Tensor, what: str) -> int:
    """Raise on a tensor the kernels do not take; its element count a 16-byte
    vector."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: the MoE kernels take float32 or bfloat16, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the MoE kernels need a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the MoE kernels need a 16-byte aligned tensor")
    return 16 // t.element_size()


def _on_card(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the MoE kernels have no backward")
        if t.device.type != "cuda":
            raise ValueError(f"the MoE kernels run on cuda tensors, not {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _run_swiglu(h: torch.Tensor) -> torch.Tensor:
    vec = _check(h, "swiglu h")
    width = h.shape[-1] // 2
    if h.shape[-1] % 2 or width % vec:
        raise ValueError(f"swiglu: the gate|up width {h.shape[-1]} is not twice a multiple of {vec}")
    y = torch.empty((*h.shape[:-1], width), dtype=h.dtype, device=h.device)
    if y.numel():
        build.check(_fn("moe_swiglu_fwd")(_DTYPE_CODES[h.dtype], h.data_ptr(), y.data_ptr(), y.numel() // width,
                                          width, _stream(h)), "MoE SwiGLU kernel")
    return y


def _run_combine(y: torch.Tensor, rows: torch.Tensor, weights: torch.Tensor,
                 shared: torch.Tensor | None) -> torch.Tensor:
    vec = _check(y, "combine y")
    if y.dim() != 2 or rows.dim() != 2:
        raise ValueError(f"combine: y [rows, D] and rows [n, k], not {tuple(y.shape)} and {tuple(rows.shape)}")
    (n, k), d = rows.shape, y.shape[1]
    if d % vec:
        raise ValueError(f"combine: the width {d} is not a multiple of {vec}")
    if not 1 <= k <= MAX_CHOICES:
        raise ValueError(f"combine: {k} choices a token, the kernel takes 1 to {MAX_CHOICES}")
    if rows.dtype != torch.int64 or weights.dtype != torch.float32 or weights.shape != rows.shape:
        raise TypeError(f"combine: rows int64 and weights float32 of one shape [n, k], not {rows.dtype} "
                        f"{tuple(rows.shape)} and {weights.dtype} {tuple(weights.shape)}")
    if not (rows.is_contiguous() and weights.is_contiguous()):
        raise ValueError("combine: the MoE kernels need contiguous rows and weights")
    if shared is not None:
        _check(shared, "combine shared")
        if shared.dtype != y.dtype or shared.shape != (n, d):
            raise ValueError(f"combine: shared {shared.dtype} {tuple(shared.shape)}, want {y.dtype} {(n, d)}")
    out = torch.empty((n, d), dtype=y.dtype, device=y.device)
    if out.numel():
        build.check(_fn("moe_combine_fwd")(_DTYPE_CODES[y.dtype], y.data_ptr(), rows.data_ptr(), weights.data_ptr(),
                                           None if shared is None else shared.data_ptr(), out.data_ptr(), n, k, d,
                                           _stream(y)), "MoE combine kernel")
    return out


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """h ``[..., 2I]`` (gate, then up) on the card -> ``silu(gate) * up``,
    ``[..., I]`` in h's dtype, computed in f32."""
    _on_card(h)
    with KERNELS.span("kernel.moe_swiglu"):
        y = _run_swiglu(h)
    if y.numel():
        KERNELS.count("moe_swiglu")
    return y


def combine(y: torch.Tensor, rows: torch.Tensor, weights: torch.Tensor,
            shared: torch.Tensor | None = None) -> torch.Tensor:
    """Sorted expert rows y ``[M, D]`` on the card -> ``[n, D]`` in y's dtype:
    token t's rows ``rows[t]`` weighted by ``weights[t]`` and summed in f32 in
    choice order, rounded, then ``shared[t]`` added and rounded again where
    given."""
    _on_card(y, rows, weights, *(() if shared is None else (shared,)))
    with KERNELS.span("kernel.moe_combine"):
        out = _run_combine(y, rows, weights, shared)
    if out.numel():
        KERNELS.count("moe_combine")
    return out
