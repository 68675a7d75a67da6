"""Fused residual add + normalization + matmul prologue: the hand-written
Hopper kernel (``csrc/fused_ln_matmul.cu``) and its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/fused_ln_matmul.py``:

    x_new = x + delta              (residual add; delta optional)
    h     = norm(x_new)            (LayerNorm with f32 stats, or Gemma RMSNorm)
    y     = act(h @ W + b)         (f32 accumulation)

returning ``(x_new, y)``. Both versions round where the JAX ``_reference``
does: ``x_new`` to x's dtype before the norm, ``h`` to x's dtype before the
product, and ``y`` to x's dtype before an f32 activation.

On the card a call is two launches on the current stream: a row pass that
writes ``x_new`` and ``h`` (a scratch tensor the wrapper allocates) and a
product pass, a hand-written GEMM from device memory with the bias and the
activation in its epilogue (the source's header note says why ``h`` goes
through device memory). :func:`fused_res_norm_rows` runs the row pass alone;
the plain version is split the same way (:func:`reference_rows`,
:func:`reference_product`).

:func:`fused_res_norm_matmul` launches the kernels for CUDA tensors and
raises on anything they do not take (there is no ``d % 128`` escape: that is
a TPU lane rule); it takes the plain version only for tensors that lie on
the CPU. Like the JAX kernel's ``custom_vjp``, the gradient recomputes
through the plain version; a call that needs no gradient skips the autograd
Function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import KERNELS
from . import build
from .activation_cuda import ACT_CODES, ACTIVATIONS  # f32 in, f32 out; the JAX module's _ACTS

NORMS = ("ln", "rms_gemma")
_ACT_CODES = {None: 0, **ACT_CODES}

_c = ctypes
_ARGTYPES = {
    "fused_ln_matmul_fwd": [_c.c_int] + [_c.c_void_p] * 9 + [_c.c_int] * 5 + [_c.c_float] + [_c.c_int] * 2
    + [_c.c_void_p],
    "fused_ln_rows_fwd": [_c.c_int] + [_c.c_void_p] * 6 + [_c.c_int] * 3 + [_c.c_float, _c.c_int, _c.c_void_p],
}
_fns: dict = {}  # the C entry points, typed once


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("fused_ln_matmul"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def _norm_f32(xf, gamma_f, beta_f, *, norm: str, eps: float) -> torch.Tensor:
    """Row normalization in f32 (``fused_ln_matmul._norm_f32``)."""
    if norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        return (xf - mu) * torch.rsqrt(var + eps) * gamma_f + beta_f
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + gamma_f)


def reference_rows(x, delta, gamma, beta, *, norm: str = "ln", eps: float = 1e-5):
    """The plain row pass: ``(x_new, h)`` in x's dtype, op for op the first
    half of ``fused_ln_matmul._reference``."""
    xf = x.float()
    if delta is not None:
        xf = xf + delta.float()
    x_new = xf.to(x.dtype)
    beta_f = beta.float() if beta is not None else 0.0
    h = _norm_f32(x_new.float(), gamma.float(), beta_f, norm=norm, eps=eps).to(x.dtype)
    return x_new, h


def reference_product(h, w, b, *, act: str | None = None):
    """The plain product: ``act(h @ w + b)`` in h's dtype, the second half
    of ``fused_ln_matmul._reference``."""
    y = torch.matmul(h.float(), w.float())
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = ACTIVATIONS[act](y.to(h.dtype).float())
    return y.to(h.dtype)


def reference(x, delta, gamma, beta, w, b, *, norm: str = "ln", eps: float = 1e-5, act: str | None = None):
    """The plain version, op for op ``fused_ln_matmul._reference``."""
    x_new, h = reference_rows(x, delta, gamma, beta, norm=norm, eps=eps)
    return x_new, reference_product(h, w, b, act=act)


def _check_rows(x, delta, gamma, beta, norm):
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, not {norm!r}")
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be [B, T, D] or [T, D], not {tuple(x.shape)}")
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} must match x {tuple(x.shape)}")
    d = x.shape[-1]
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v is not None and tuple(v.shape) != (d,):
            raise ValueError(f"{name} must be [{d}], not {tuple(v.shape)}")


def _check(x, delta, gamma, beta, w, b, norm, act):
    _check_rows(x, delta, gamma, beta, norm)
    if act not in _ACT_CODES:
        raise ValueError(f"act must be None or one of {tuple(ACTIVATIONS)}, not {act!r}")
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be [D, N] with D = {d}, not {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b must be [{w.shape[1]}], not {tuple(b.shape)}")


def _rows_args(x, delta, gamma, beta):
    """The row pass's checked operands: (x2, d2, gamma, beta, gb_vec, m, d)
    with x and delta flattened to rows."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prologue kernel takes bfloat16 or float32, not {x.dtype}")
    for name, v in (("delta", delta), ("gamma", gamma), ("beta", beta)):
        if v is not None and (v.dtype != x.dtype or v.device != x.device):
            raise ValueError(f"{name} must match x's dtype and device")
    d = x.shape[-1]
    if d % 8 or d == 0:
        raise ValueError(f"prologue kernel takes a row width that is a positive multiple of 8, not {d}")
    x2 = x.reshape(-1, d).contiguous()
    d2 = None if delta is None else delta.reshape(-1, d).contiguous()
    if any(t.data_ptr() % 16 for t in (x2,) + (() if d2 is None else (d2,))):
        raise ValueError("prologue kernel needs 16-byte aligned rows of x and delta")
    gamma = gamma.contiguous()
    beta = None if beta is None else beta.contiguous()
    gb_vec = int(all(t.data_ptr() % 16 == 0 for t in (gamma,) + (() if beta is None else (beta,))))
    return x2, d2, gamma, beta, gb_vec, x2.shape[0], d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x, delta, gamma, beta, w, b, norm, eps, act):
    """The kernels' call, counted once under ``fused_res_norm_matmul`` though
    it is two device launches (the row pass, then the product)."""
    with KERNELS.span("kernel.fused_res_norm_matmul"):
        return _run(x, delta, gamma, beta, w, b, norm, eps, act)


def _run(x, delta, gamma, beta, w, b, norm, eps, act):
    x2, d2, gamma, beta, gb_vec, m, d = _rows_args(x, delta, gamma, beta)
    for name, v in (("w", w), ("b", b)):
        if v is not None and (v.dtype != x.dtype or v.device != x.device):
            raise ValueError(f"{name} must match x's dtype and device")
    n = w.shape[1]
    w = w.contiguous()
    b = None if b is None else b.contiguous()
    x_new = torch.empty_like(x2)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return x_new.reshape(x.shape), y.reshape(*x.shape[:-1], n)
    h = torch.empty_like(x2)  # the row pass's output, the product's A operand
    w_vec = int(w.data_ptr() % 16 == 0 and (n * w.element_size()) % 16 == 0)
    code = _entry("fused_ln_matmul_fwd")(
        1 if x.dtype == torch.bfloat16 else 0, x2.data_ptr(), _ptr(d2), gamma.data_ptr(), _ptr(beta),
        w.data_ptr(), _ptr(b), x_new.data_ptr(), h.data_ptr(), y.data_ptr(), m, d, n, NORMS.index(norm),
        _ACT_CODES[act], float(eps), gb_vec, w_vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "prologue kernel")
    KERNELS.count("fused_res_norm_matmul")
    return x_new.reshape(x.shape), y.reshape(*x.shape[:-1], n)


class _FusedResNormMatmul(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version (the
    JAX kernel's custom_vjp design: nothing extra is saved)."""

    @staticmethod
    def forward(ctx, x, delta, gamma, beta, w, b, norm, eps, act):
        ctx.save_for_backward(x, delta, gamma, beta, w, b)
        ctx.args = dict(norm=norm, eps=eps, act=act)
        return _launch(x, delta, gamma, beta, w, b, norm, eps, act)

    @staticmethod
    def backward(ctx, g_xnew, g_y):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_() for t in saved]
            outs = reference(*ins, **ctx.args)
            present = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(outs, present, (g_xnew, g_y)))
        return (*(None if t is None else next(grads) for t in ins), None, None, None)


def fused_res_norm_matmul(
    x: torch.Tensor,
    delta: torch.Tensor | None,
    gamma: torch.Tensor,
    beta: torch.Tensor | None,
    w: torch.Tensor,
    b: torch.Tensor | None,
    *,
    norm: str = "ln",
    eps: float = 1e-5,
    act: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_new, act(norm(x + delta) @ w + b)).

    x, delta: [B, T, D] or [T, D]; gamma, beta: [D]; w: [D, N]; b: [N].
    norm: "ln" (LayerNorm) or "rms_gemma" (RMSNorm with (1 + gamma) gain, no
    beta or bias). Returns (x_new [..., D], y [..., N]) in x's dtype."""
    _check(x, delta, gamma, beta, w, b, norm, act)
    if x.device.type == "cpu":
        return reference(x, delta, gamma, beta, w, b, norm=norm, eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_res_norm_matmul runs on cuda (kernel) or cpu (plain), not {x.device}")
    ins = [t for t in (x, delta, gamma, beta, w, b) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _FusedResNormMatmul.apply(x, delta, gamma, beta, w, b, norm, float(eps), act)
    return _launch(x, delta, gamma, beta, w, b, norm, float(eps), act)  # inference: no autograd Function


def fused_res_norm_rows(
    x: torch.Tensor,
    delta: torch.Tensor | None,
    gamma: torch.Tensor,
    beta: torch.Tensor | None,
    *,
    norm: str = "ln",
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The prologue's row pass alone: ``(x_new, h)`` in x's dtype, each
    shaped like x. Its kernel on CUDA tensors, :func:`reference_rows` on CPU
    tensors; no gradient (it exists to check and time the row pass)."""
    _check_rows(x, delta, gamma, beta, norm)
    if x.device.type == "cpu":
        return reference_rows(x, delta, gamma, beta, norm=norm, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_res_norm_rows runs on cuda (kernel) or cpu (plain), not {x.device}")
    x2, d2, gamma, beta, gb_vec, m, d = _rows_args(x, delta, gamma, beta)
    x_new, h = torch.empty_like(x2), torch.empty_like(x2)
    if m:
        code = _entry("fused_ln_rows_fwd")(
            1 if x.dtype == torch.bfloat16 else 0, x2.data_ptr(), _ptr(d2), gamma.data_ptr(), _ptr(beta),
            x_new.data_ptr(), h.data_ptr(), m, d, NORMS.index(norm), float(eps), gb_vec,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        build.check(code, "prologue row pass")
        KERNELS.count("fused_res_norm_rows")
    return x_new.reshape(x.shape), h.reshape(x.shape)
