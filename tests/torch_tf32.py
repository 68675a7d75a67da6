"""numpy emulation of the 3xTF32 products of the port's f32 kernels.

The f32 bodies of ``csrc/attention.cu`` and ``csrc/maxsim.cu`` multiply on
the tensor cores with ``mma.sync.m16n8k8.f32.tf32.tf32.f32``. Each f32
operand x is split in registers into a TF32 high part and a TF32 low part,
x ~ hi + lo, and a product is accumulated in f32 as three mma,

    a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi   (a_lo.b_lo, about 2^-22 a.b, dropped)

in chunks of 8 along the reduced dim. TF32 keeps 10 explicit mantissa bits;
rounding is emulated on the f32 bit pattern:

- "rne": round to nearest, ties to even, for both parts;
- "kernel": what the kernels do, two integer ops a part: hi rounded to
  nearest with ties away from zero (``(u + 0x1000) & 0xffffe000``), lo =
  x - hi (exact in f32) truncated to 10 bits (``& 0xffffe000``).

A chunk's 8 products are exact (11-bit by 11-bit significands) and are
summed here in f64, then added to the f32 accumulator with one rounding to
nearest. The tensor core's own accumulator rounds toward zero instead, a
drift that grows with the number of chunks in one chain; the kernels keep
each chain to 64 elements of the reduced dim (or one 32-key tile) and add
it into f32 registers rounded to nearest, which this emulation stands for.
"""

import numpy as np

_MASK = np.uint32(0xFFFFE000)
ROUNDINGS = {"rne": ("rne", "rne"), "kernel": ("rna", "rz")}


def tf32(x, mode: str) -> np.ndarray:
    """x (f32) rounded to TF32 by ``mode``: "rne", "rna" or "rz"."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if mode == "rne":
        u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))) & _MASK
    elif mode == "rna":
        u = (u + np.uint32(0x1000)) & _MASK
    elif mode == "rz":
        u = u & _MASK
    else:
        raise ValueError(mode)
    return u.view(np.float32)


def split(x, rounding: str) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) of f32 x under ``rounding`` ("rne" or "kernel")."""
    hi_mode, lo_mode = ROUNDINGS[rounding]
    x = np.asarray(x, np.float32)
    hi = tf32(x, hi_mode)
    return hi, tf32(x - hi, lo_mode)


def matmul(a, b, rounding: str, passes: int = 3) -> np.ndarray:
    """a [..., M, K] @ b [..., K, N] in f32 as the kernels compute it:
    ``passes`` 3 is 3xTF32 under ``rounding``; 1 is single-pass TF32
    (``a_hi.b_hi`` only), which the f32 kernels may not use."""
    ah, al = split(a, rounding)
    bh, bl = split(b, rounding)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    k = a.shape[-1]
    acc = np.zeros(np.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, b.shape[-1])), np.float32)
    for k0 in range(0, k, 8):
        for x, y in terms:
            chunk = x[..., k0 : k0 + 8].astype(np.float64) @ y[..., k0 : k0 + 8, :].astype(np.float64)
            acc = (acc + chunk).astype(np.float32)
    return acc


def attention(q, k, v, km, *, causal: bool, scale: float, rounding: str, passes: int = 3) -> np.ndarray:
    """The f32 attention kernel's arithmetic, ``[B, H, T, Dh]`` layout (k, v
    ``[B, KVH, Tk, Dh]``): QK^T and PV by :func:`matmul`, finite ``-1e30``
    masking, the exact row max, p = exp((l - m) * scale) and its f32 sum,
    ``any_valid / denom`` after PV."""
    b, h, tq, _ = q.shape
    kvh, tk = k.shape[1], k.shape[2]
    k, v = np.repeat(k, h // kvh, axis=1), np.repeat(v, h // kvh, axis=1)
    logits = matmul(q, np.swapaxes(k, -1, -2), rounding, passes)
    valid = np.ones((b, 1, tq, tk), bool)
    if km is not None:
        valid = valid & (km[:, None, None, :] != 0)
    if causal:
        valid = valid & np.tril(np.ones((tq, tk), bool))
    logits = np.where(valid, logits, np.float32(-1e30)).astype(np.float32)
    m = logits.max(-1, keepdims=True)
    p = np.exp((logits - m) * np.float32(scale)).astype(np.float32)
    denom = p.sum(-1, keepdims=True, dtype=np.float32)
    r = valid.any(-1, keepdims=True).astype(np.float32) / denom
    return matmul(p, v, rounding, passes) * r


def maxsim(q, d, qm, dm, *, rounding: str, passes: int = 3) -> np.ndarray:
    """The f32 MaxSim kernel's arithmetic: similarities by :func:`matmul`,
    ``-1e30`` for masked doc tokens, the max over each doc's tokens, the
    qm-weighted f32 sum over query tokens. q [NQ, TQ, D], d [ND, TD, D]."""
    nq, tq, dim = q.shape
    nd, td, _ = d.shape
    sim = matmul(q.reshape(nq * tq, dim), d.reshape(nd * td, dim).T, rounding, passes)
    sim = np.where(dm.reshape(1, nd * td), sim, np.float32(-1e30)).reshape(nq, tq, nd, td)
    return (sim.max(-1) * qm[:, :, None]).sum(1, dtype=np.float32)
