"""Mamba-2's selective state-space scan: for each sequence and head h, with
the head's state S [P, N] in f32,

    S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) B_t^T,
    y_t = S_t C_t + D_h * x_t,

over x [B, T, H, P], dt [B, T, H] (after the softplus), B and C [B, T, N]
(one group, every head reads the same), A [H] (f32, negative) and D [H]; y
[B, T, H, P] in x's dtype.

:func:`scan` runs the hand-written kernel on CUDA tensors (``ops/ssm_cuda.py``,
``csrc/ssm.cu``: in bf16 this chunked form in chunks of 64 tokens on the
tensor cores, in f32 the recurrence token by token; the state in registers
either way) and :func:`scan_plain` on CPU tensors; the plain version never
runs on the card.

:func:`scan_plain` is the chunked form of the same recurrence (Mamba-2's SSD,
arXiv:2405.21060, as ``transformers``' ``torch_forward`` writes it), in f32:
within a chunk of ``chunk`` tokens the outputs are a masked product with the
decays ``exp(cumsum(dt * A))`` between each pair of tokens, and the state at
each chunk's end is carried into the next chunk by a loop over the chunks. A
sequence that is not a whole number of chunks is padded with tokens of no
input and no decay (x = 0, dt = 0), which leave the state as it is.
"""

from __future__ import annotations

import torch

from . import ssm_cuda


def scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               D: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The scan in f32, chunk by chunk; y in x's dtype."""
    b, t, h, p = x.shape
    pad = -t % chunk
    xf, dtf, bf, cf = (torch.nn.functional.pad(v.float(), (0, 0) * (v.dim() - 2) + (0, pad))
                       for v in (x, dt, B, C))
    nc = (t + pad) // chunk
    xc = xf.view(b, nc, chunk, h, p)
    dtc = dtf.view(b, nc, chunk, h)
    bc, cc = bf.view(b, nc, chunk, -1), cf.view(b, nc, chunk, -1)
    cum = torch.cumsum(dtc * A.float(), dim=2)  # [b, c, l, h]: the log decay from the chunk's start
    # within a chunk: y_l = sum_{s <= l} exp(cum_l - cum_s) (C_l . B_s) dt_s x_s
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(~causal[:, :, None], -torch.inf)
    weight = torch.einsum("bcln,bcsn->bcls", cc, bc)[..., None] * torch.exp(seg) * dtc[:, :, None]
    y = torch.einsum("bclsh,bcshp->bclhp", weight, xc)
    # each chunk's own contribution to the state at its end
    into_end = torch.exp(cum[:, :, -1:] - cum) * dtc  # [b, c, l, h]
    own = torch.einsum("bclh,bclhp,bcln->bchpn", into_end, xc, bc)
    state = xf.new_zeros(b, h, p, bc.shape[-1])
    for c in range(nc):  # the state carried in from the chunks before
        y[:, c] += torch.einsum("blh,bln,bhpn->blhp", torch.exp(cum[:, c]), cc[:, c], state)
        state = torch.exp(cum[:, c, -1])[:, :, None, None] * state + own[:, c]
    y = y.reshape(b, t + pad, h, p)[:, :t] + D.float()[:, None] * x.float()
    return y.to(x.dtype)


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
         *, chunk: int) -> torch.Tensor:
    """:func:`scan_plain` on CPU tensors; the kernel on the card, which takes
    no chunk (its chunked body's chunk is fixed at 64 tokens)."""
    if x.device.type == "cpu":
        return scan_plain(x, dt, A, B, C, D, chunk=chunk)
    return ssm_cuda.scan(x, dt, A, B, C, D)
