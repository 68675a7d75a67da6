"""The products of the reference, in a stated precision.

- "f32": float32 products with TF32 off (the reference itself).
- "tf32": both operands of every product rounded to TF32 (10 mantissa
  bits, to nearest) and then multiplied as float32: the products of the
  TF32 tensor cores, the same on the card and the CPU (the control of a
  float32 path).
- "fp8": both operands of every product rounded to float8 e4m3 with one
  scale a tensor (its largest magnitude to 448), accumulated in float32
  (the control of a bfloat16 path).
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def precision(name: str):
    """Float32 products with TF32 off (each precision rounds its operands
    itself); the previous settings restored."""
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (half away from zero in
    magnitude), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in float32, the operands first rounded to the precision's."""
    a, b = a.float(), b.float()
    if prec != "f32":
        rnd = fp8 if prec == "fp8" else tf32
        a, b = rnd(a), rnd(b)
    return a @ b
