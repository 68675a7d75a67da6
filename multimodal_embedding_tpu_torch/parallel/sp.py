"""Sequence parallelism over the mesh's model axis.

Counterpart of ``multimodal_embedding_tpu/parallel/sp.py``. ColPali's Gemma
runs on this rank's shard of the tokens: projections, rope, norms and MLPs
are token-local, and the attention all-gathers K, V and the key mask along
the tokens (:func:`sp_attention`). The local body is the JAX function's XLA
einsum, so here it is plain PyTorch, not a kernel: f32 logits, the finite
``-1e30`` mask, grouped-query heads, and causal rows offset by this rank's
first token. The JAX ``sp_shardings`` placements are :func:`shard_tokens`
and :func:`gather_tokens`.
"""

from __future__ import annotations

import math

import torch

from .. import runtime
from .mesh import Mesh, all_gather_cat

NEG_INF = -1e30


def sp_mesh_for(t: int) -> Mesh | None:
    """The registered sequence-parallel mesh where its model axis divides a
    sequence of ``t`` tokens; None otherwise (the whole sequence then runs on
    every rank, as the JAX package falls through)."""
    sp = runtime.current().sp
    return sp if sp is not None and t % sp.n_model == 0 else None


def shard_tokens(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This model rank's contiguous shard of ``x`` along ``dim``."""
    per = x.shape[dim] // mesh.n_model
    return x.narrow(dim, mesh.model_rank * per, per)


def gather_tokens(x: torch.Tensor, mesh: Mesh | None, dim: int = 1) -> torch.Tensor:
    """Every model rank's token shard, in order, on every rank."""
    if mesh is None:
        return x
    return all_gather_cat(x, mesh.model_group, mesh.n_model, dim=dim)


def sp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    key_mask: torch.Tensor | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel SDPA. q [B, H, T/n, Dh], k and v [B, KVH, T/n, Dh]
    (KVH | H) and key_mask [B, T/n] (True = attend) are this rank's token
    shard; returns this rank's [B, H, T/n, Dh] in q's dtype."""
    b, h, tl, dh = q.shape
    kvh = k.shape[1]
    if h % kvh:
        raise ValueError(f"{kvh} kv heads do not divide {h} query heads")
    n = mesh.n_model
    t = tl * n
    scale = 1.0 / math.sqrt(dh) if sm_scale is None else sm_scale
    # one gather for K and V together: [2, B, KVH, T, Dh]
    kv = gather_tokens(torch.stack([k, v]), mesh, dim=3)
    kf, vf = kv[0], kv[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, tl, dh)
    logits = torch.einsum("bkgqd,bkKd->bkgqK", qg.float(), kf.float()) * scale  # [B, KVH, G, T/n, T]
    if key_mask is not None:
        kmf = gather_tokens(key_mask.to(torch.uint8), mesh, dim=1).bool()  # [B, T]
        logits = logits.masked_fill(~kmf[:, None, None, None, :], NEG_INF)
    if causal:
        row = mesh.model_rank * tl + torch.arange(tl, device=q.device)[:, None]
        col = torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(~(col <= row), NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(vf.dtype)
    out = torch.einsum("bkgqK,bkKd->bkgqd", attn.float(), vf.float())
    return out.reshape(b, h, tl, dh).to(q.dtype)
