"""Grouped-query attention for the decoder LMs (Gemma, Qwen3).

:func:`grouped_attention` is the counterpart of
``multimodal_embedding_tpu/models/decoder_attn.py:grouped_attention``:
already projected and rope'd q [B, T, H, Dh] and k, v [B, T, KVH, Dh] ->
[B, T, H*Dh] in q's dtype, over a key mask [B, T] (True = attend; None =
every key) and a static causal flag. The encoders and the generation prefill
take it.

The implementation follows ``runtime.attention_impl``:
- "pallas" ("auto" on the card): the fused attention kernel
  (``ops/attention_cuda.py``) in its packed layout with ``num_kv_heads``,
  reading the projections through strides (no transposes, Dh 256 included);
  on CPU tensors its plain version.
- "xla" / "xla_bf16" ("auto" on the CPU): einsum attention with f32 (or
  model-dtype) logits and finite ``-1e30`` masking, as the JAX function's
  XLA branch, not the ``-inf`` of ``layers.attention_core``.
- sequence parallelism (``sp``, a mesh given by the caller where its model
  axis divides the sequence, ``parallel/sp.py:sp_mesh_for``): q, k and v are
  this rank's token shard and ``parallel/sp.py:sp_attention`` gathers K and
  V, before any other branch. Where the axis does not divide the sequence
  the caller passes none, and every rank runs the whole sequence, as the
  JAX function falls through.

:func:`decode_attention` is one generation step's attention over a KV cache,
the einsum of the JAX decode steps (``models/qwen3.py:192-198``,
``models/gemma.py:210-215``), which no Pallas kernel runs: plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from .. import runtime

NEG_INF = -1e30


def grouped_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: torch.Tensor | None,
    causal: bool,
    sm_scale: float,
    sp=None,
) -> torch.Tensor:
    """Self-attention over grouped heads -> [B, T, H*Dh] (q's dtype)."""
    b, t, heads, dh = q.shape
    kv_heads = k.shape[2]
    if sp is not None:
        from ..parallel.sp import sp_attention

        out = sp_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), sp, key_mask=key_mask,
                           causal=causal, sm_scale=sm_scale)
        return out.transpose(1, 2).reshape(b, t, heads * dh)
    impl = runtime.attention_impl(q.device)
    if impl == "pallas":
        from ..ops.attention_cuda import fused_attention

        out = fused_attention(
            q.reshape(b, t, heads * dh), k.reshape(b, t, kv_heads * dh), v.reshape(b, t, kv_heads * dh),
            key_mask, causal=causal, sm_scale=sm_scale, layout="packed", num_heads=heads,
            num_kv_heads=kv_heads,
        )
        return out.to(q.dtype)

    g = heads // kv_heads  # query heads per kv head
    qg = q.reshape(b, t, kv_heads, g, dh)
    if impl == "xla_bf16":
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    else:
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * sm_scale
    valid = None
    if key_mask is not None:
        valid = key_mask.bool()[:, None, None, None, :]
    if causal:
        cm = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        valid = cm if valid is None else valid & cm
    if valid is not None:
        logits = logits.masked_fill(~valid, NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", attn.float(), v.float())
    return out.to(q.dtype).reshape(b, t, heads * dh)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P] accumulated and returned in f32; on the card
    a bf16 product writes f32 straight from cuBLAS (no f32 copy of b)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_valid: torch.Tensor,
) -> torch.Tensor:
    """One query token a row against a KV cache: q [B, 1, H, Dh], caches
    [B, KVH, S, Dh] (KVH | H), cache_valid [B, S] (True = attend) -> [B, 1,
    H*Dh] in q's dtype. As the JAX decode steps: f32 logits divided by
    sqrt(Dh), finite ``-1e30`` masking, f32 softmax cast to q's dtype, then
    an f32-accumulated PV rounded once to q's dtype."""
    b, _, heads, dh = q.shape
    kv_heads, s = k_cache.shape[1], k_cache.shape[2]
    g = heads // kv_heads  # query heads per kv head: head = kv head * g + j
    qh = q.reshape(b * kv_heads, g, dh)
    logits = _bmm_f32(qh, k_cache.reshape(b * kv_heads, s, dh).transpose(1, 2)) / math.sqrt(dh)
    logits = logits.view(b, kv_heads, g, s).masked_fill(~cache_valid[:, None, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.bmm(attn.view(b * kv_heads, g, s), v_cache.reshape(b * kv_heads, s, dh))
    return out.reshape(b, 1, heads * dh)
