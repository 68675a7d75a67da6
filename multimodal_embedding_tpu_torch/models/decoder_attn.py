"""Grouped-query self-attention for the decoder LMs (Gemma).

Counterpart of ``multimodal_embedding_tpu/models/decoder_attn.py:
grouped_attention``: already projected and rope'd q [B, T, H, Dh] and k, v
[B, T, KVH, Dh] -> [B, T, H*Dh] in q's dtype, over a key mask [B, T] (True =
attend; None = every key) and a static causal flag.

The implementation follows ``layers.set_attention_impl``:
- "pallas" ("auto" on the card): the fused attention kernel
  (``ops/attention_cuda.py``) in its packed layout with ``num_kv_heads``,
  reading the projections through strides (no transposes, Dh 256 included);
  on CPU tensors its plain version.
- "xla" / "xla_bf16" ("auto" on the CPU): einsum attention with f32 (or
  model-dtype) logits and finite ``-1e30`` masking, as the JAX function's
  XLA branch, not the ``-inf`` of ``layers.attention_core``.
The sequence-parallel branch is not yet ported.
"""

from __future__ import annotations

import torch

from .layers import attention_impl_for

NEG_INF = -1e30


def grouped_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: torch.Tensor | None,
    causal: bool,
    sm_scale: float,
) -> torch.Tensor:
    """Self-attention over grouped heads -> [B, T, H*Dh] (q's dtype)."""
    b, t, heads, dh = q.shape
    kv_heads = k.shape[2]
    impl = attention_impl_for(q)
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
