"""Fused residual add + normalization + matmul prologue: the hand-written
Hopper kernel (``csrc/fused_ln_matmul.cu``) and its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/fused_ln_matmul.py``. In one
pass over the activations:

    x_new = x + delta              (residual add; delta optional)
    h     = norm(x_new)            (LayerNorm with f32 stats, or Gemma RMSNorm)
    y     = act(h @ W + b)         (f32 accumulation)

returning ``(x_new, y)``. Both versions round where the JAX ``_reference``
does: ``x_new`` to x's dtype before the norm, ``h`` to x's dtype before the
product, and ``y`` to x's dtype before an f32 activation.

:func:`fused_res_norm_matmul` launches the kernel for CUDA tensors and raises
on anything the kernel does not take (there is no ``d % 128`` escape: that
is a TPU lane rule); it takes the plain version only for tensors that lie on
the CPU. Like the JAX kernel's ``custom_vjp``, the gradient recomputes
through the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

NORMS = ("ln", "rms_gemma")
# f32 in, f32 out; the JAX module's _ACTS (and models/layers.py's ACTIVATIONS)
ACTS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_pytorch_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}
_ACT_CODES = {None: 0, "gelu": 1, "quick_gelu": 2, "gelu_pytorch_tanh": 3}

# Kernel launches made by fused_res_norm_matmul (a plain count, read by chip_smoke.py).
launches = 0

_c = ctypes
_ARGTYPES = [_c.c_int] + [_c.c_void_p] * 8 + [_c.c_int] * 5 + [_c.c_float, _c.c_int, _c.c_void_p]


def _norm_f32(xf, gamma_f, beta_f, *, norm: str, eps: float) -> torch.Tensor:
    """Row normalization in f32 (``fused_ln_matmul._norm_f32``)."""
    if norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        return (xf - mu) * torch.rsqrt(var + eps) * gamma_f + beta_f
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + gamma_f)


def reference(x, delta, gamma, beta, w, b, *, norm: str = "ln", eps: float = 1e-5, act: str | None = None):
    """The plain version, op for op ``fused_ln_matmul._reference``."""
    xf = x.float()
    if delta is not None:
        xf = xf + delta.float()
    x_new = xf.to(x.dtype)
    beta_f = beta.float() if beta is not None else 0.0
    h = _norm_f32(x_new.float(), gamma.float(), beta_f, norm=norm, eps=eps).to(x.dtype)
    y = torch.matmul(h.float(), w.float())
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = ACTS[act](y.to(x.dtype).float())
    return x_new, y.to(x.dtype)


def _check(x, delta, gamma, beta, w, b, norm, act):
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, not {norm!r}")
    if act not in _ACT_CODES:
        raise ValueError(f"act must be None or one of {tuple(ACTS)}, not {act!r}")
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be [B, T, D] or [T, D], not {tuple(x.shape)}")
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be [D, N] with D = {d}, not {tuple(w.shape)}")
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} must match x {tuple(x.shape)}")
    for name, v, n in (("gamma", gamma, d), ("beta", beta, d), ("b", b, w.shape[1])):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], not {tuple(v.shape)}")


def _launch(x, delta, gamma, beta, w, b, norm, eps, act):
    global launches
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prologue kernel takes bfloat16 or float32, not {x.dtype}")
    for name, v in (("delta", delta), ("gamma", gamma), ("beta", beta), ("w", w), ("b", b)):
        if v is not None and (v.dtype != x.dtype or v.device != x.device):
            raise ValueError(f"{name} must match x's dtype and device")
    d, n = x.shape[-1], w.shape[1]
    if d % 8:
        raise ValueError(f"prologue kernel takes a row width that is a multiple of 8, not {d}")
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    d2 = None if delta is None else delta.reshape(-1, d).contiguous()
    w, gamma = w.contiguous(), gamma.contiguous()
    beta = None if beta is None else beta.contiguous()
    b = None if b is None else b.contiguous()
    x_new = torch.empty_like(x2)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return x_new.reshape(x.shape), y.reshape(*x.shape[:-1], n)
    if any(t.data_ptr() % 16 for t in (x2, x_new) + (() if d2 is None else (d2,))):
        raise ValueError("prologue kernel needs 16-byte aligned rows of x, delta and x_new")
    w_vec = int(w.data_ptr() % 16 == 0 and (n * w.element_size()) % 16 == 0)
    fn = build.load("fused_ln_matmul").fused_ln_matmul_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.profiler.record_function("fused_res_norm_matmul"):
        code = fn(
            1 if x.dtype == torch.bfloat16 else 0,
            x2.data_ptr(), None if d2 is None else d2.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            x_new.data_ptr(), y.data_ptr(), m, d, n, NORMS.index(norm), _ACT_CODES[act], float(eps), w_vec,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(code, "prologue kernel")
    launches += 1
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
    return _FusedResNormMatmul.apply(x, delta, gamma, beta, w, b, norm, float(eps), act)
