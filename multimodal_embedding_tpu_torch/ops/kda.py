"""Kimi Delta Attention's recurrence (KDA, arXiv:2510.26692): a gated delta
rule whose decay has one value for each key channel. For each sequence and
head, with the state S [K, V] in f32,

    S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
    o_t = S_t^T (q_t / sqrt(K)),

over q, k, v [B, T, H, K] (K = V), each q_t and k_t L2-normalised first
(``x * rsqrt(sum(x^2) + 1e-6)``, as the published kernel's
``use_qk_l2norm_in_kernel``), the log decays ``g = log(alpha)`` [B, T, H, K]
in f32 (each at most 0) and ``beta`` [B, T, H] in f32; o [B, T, H, V] in v's
dtype.

:func:`kda` runs the hand-written kernel on CUDA tensors (``ops/kda_cuda.py``,
``csrc/kda.cu``) and :func:`kda_plain` on CPU tensors; the plain version never
runs on the card.

:func:`kda_plain` is the chunked (WY) form of the same recurrence in f32.
Within a chunk of ``chunk`` tokens, with G the chunk's inclusive cumulative
sum of g (one value a channel) and S_0 the state at the chunk's start, the
delta rule's corrections u_t = beta_t (v_t - (Diag(alpha_t) S_{t-1})^T k_t)
solve the unit lower-triangular system

    (I + A) U = diag(beta) (V - (K * exp(G)) S_0),
    A[t, s] = beta_t sum_c k_t[c] k_s[c] exp(G_t[c] - G_s[c])   (s < t),

and then

    O = (Q * exp(G)) S_0 + M U,   M[t, s] = sum_c q_t[c] k_s[c] exp(G_t[c] - G_s[c])   (s <= t),
    S_end = Diag(exp(G_end)) S_0 + (K * exp(G_end - G))^T U.

Each pair's decay is formed as ``exp(G_t - G_s)`` channel by channel, never as
a product of exp(G_t) and exp(-G_s): over a chunk G reaches -100 and below at
strong decays, where exp(-G) overflows f32. A sequence that is not a whole
number of chunks ends in a shorter chunk.
"""

from __future__ import annotations

import torch

from . import kda_cuda

L2_EPS = 1e-6


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + 1e-6)`` over the last axis, in x's dtype."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + L2_EPS)


def kda_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor, *,
              chunk: int = 64) -> torch.Tensor:
    """The recurrence in f32, chunk by chunk; o in v's dtype."""
    b, t, h, kd = q.shape
    vd, dtype = v.shape[-1], v.dtype
    q = l2_normalize(q.float()) * kd**-0.5
    k = l2_normalize(k.float())
    v, g, beta = v.float(), g.float(), beta.float()
    state = q.new_zeros(b, h, kd, vd)
    out = []
    for c0 in range(0, t, chunk):
        qc, kc, vc, gc, bc = (x[:, c0 : c0 + chunk] for x in (q, k, v, g, beta))
        n = qc.shape[1]
        cum = torch.cumsum(gc, dim=1)  # [b, n, h, K]
        # each pair's decay, channel by channel: exp(G_t - G_s) for s <= t
        lower = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        seg = (cum[:, :, None] - cum[:, None, :]).masked_fill(~lower[None, :, :, None, None], -torch.inf)
        decay = torch.exp(seg)  # [b, t, s, h, K]
        a = torch.einsum("bthc,bshc,btshc->bhts", kc, kc, decay)
        a = (a * bc.permute(0, 2, 1)[..., None]).tril(-1)
        m = torch.einsum("bthc,bshc,btshc->bhts", qc, kc, decay)
        rhs = bc.permute(0, 2, 1)[..., None] * (vc.transpose(1, 2) - torch.einsum("bthc,bhcv->bhtv",
                                                                                   kc * torch.exp(cum), state))
        eye = torch.eye(n, dtype=q.dtype, device=q.device)
        u = torch.linalg.solve_triangular(eye + a, rhs, upper=False, unitriangular=True)  # [b, h, n, V]
        o = torch.einsum("bthc,bhcv->bhtv", qc * torch.exp(cum), state) + m @ u
        out.append(o.transpose(1, 2))
        end = cum[:, -1]  # [b, h, K]
        state = torch.exp(end)[..., None] * state + torch.einsum("bthc,bhtv->bhcv", kc * torch.exp(end[:, None] - cum),
                                                                 u)
    return torch.cat(out, dim=1).to(dtype)


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """:func:`kda_plain` on CPU tensors; the kernel on the card."""
    if q.device.type == "cpu":
        return kda_plain(q, k, v, g, beta)
    return kda_cuda.kda(q, k, v, g, beta)
