"""Gemma decoder, the language tower inside ColPali's PaliGemma backbone.

Counterpart of ``multimodal_embedding_tpu/models/gemma.py`` for the
embedding path (``gemma_apply``, ``gemma_embed``); generation
(``gemma_prefill``, ``gemma_decode_step``, ``gemma_lm_logits``) is not yet
ported. The HF ``GemmaModel`` semantics, as in the JAX package:

- token embeddings scaled by sqrt(dim), rounded to the embedding dtype;
- RMSNorm with a (1 + weight) gain and f32 statistics;
- rotary position embeddings (rotate-half, full head dim) in f32, with
  positions cumsum(mask) - 1 (left padding supported);
- multi-query attention (``models/decoder_attn.py``), scale 1/sqrt(head_dim),
  over a key mask and an optional causal flag;
- a GeGLU MLP with tanh-approximated GELU in f32.

Weights keep the JAX layouts (a projection is ``[d_in, d_out]``), with the
``[L, ...]``-stacked layers unrolled into ``layers.<i>``. In bf16 the q/k/v,
gate and up products are rounded to bf16 by the matmul (the JAX package
keeps gate and up in f32 before the GELU): at most one bf16 rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .decoder_attn import grouped_attention


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics and a (1 + w) gain, returned in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, Dh], positions [B, T]; rotate-half rotary embedding in f32,
    returned in x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, :, None].float() * freq  # [B, T, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _normal(shape, std: float, gen: torch.Generator, device, dtype) -> nn.Parameter:
    t = torch.randn(shape, generator=gen, device=device) * std
    return nn.Parameter(t.to(dtype), requires_grad=False)


def _zeros(dim: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(dim, device=device, dtype=dtype), requires_grad=False)


class GemmaLayer(nn.Module):
    """One decoder layer: ``ln1``, ``attn.{q,k,v,o}``, ``ln2``,
    ``mlp.{gate,up,down}`` (the JAX tree's names)."""

    def __init__(self, cfg: GemmaConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        s = 0.02
        self.cfg = cfg
        qd, kvd = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        self.ln1 = _zeros(cfg.dim, device, dtype)
        self.attn = nn.ParameterDict({
            "q": _normal((cfg.dim, qd), s, gen, device, dtype),
            "k": _normal((cfg.dim, kvd), s, gen, device, dtype),
            "v": _normal((cfg.dim, kvd), s, gen, device, dtype),
            "o": _normal((qd, cfg.dim), s, gen, device, dtype),
        })
        self.ln2 = _zeros(cfg.dim, device, dtype)
        self.mlp = nn.ParameterDict({
            "gate": _normal((cfg.dim, cfg.mlp_dim), s, gen, device, dtype),
            "up": _normal((cfg.dim, cfg.mlp_dim), s, gen, device, dtype),
            "down": _normal((cfg.mlp_dim, cfg.dim), s, gen, device, dtype),
        })

    def _attn(self, x, positions, key_mask, causal: bool) -> torch.Tensor:
        cfg, p = self.cfg, self.attn
        b, t, _ = x.shape
        q = (x @ p["q"]).reshape(b, t, cfg.heads, cfg.head_dim)
        k = (x @ p["k"]).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        v = (x @ p["v"]).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        out = grouped_attention(q, k, v, key_mask=key_mask, causal=causal, sm_scale=1.0 / math.sqrt(cfg.head_dim))
        return out @ p["o"]

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        p = self.mlp
        h = torch.nn.functional.gelu((x @ p["gate"]).float(), approximate="tanh") * (x @ p["up"]).float()
        return h.to(x.dtype) @ p["down"]

    def forward(self, h, positions, key_mask, causal: bool = False) -> torch.Tensor:
        eps = self.cfg.rms_eps
        h = h + self._attn(rms_norm(self.ln1, h, eps), positions, key_mask, causal)
        return h + self._mlp(rms_norm(self.ln2, h, eps))


class Gemma(nn.Module):
    """Token embedding table ``embed`` [V, D], ``layers.<i>``, ``final_norm``."""

    def __init__(self, cfg: GemmaConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(GemmaLayer(cfg, gen=gen, device=device, dtype=dtype) for _ in range(cfg.layers))
        self.embed = _normal((cfg.vocab_size, cfg.dim), 0.02, gen, device, dtype)
        self.final_norm = _zeros(cfg.dim, device, dtype)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``gemma_embed``: embeddings times sqrt(dim) rounded to their dtype
        (45.25 in bf16 at dim 2048)."""
        emb = self.embed[input_ids.long()]
        return emb * torch.tensor(math.sqrt(self.cfg.dim), dtype=emb.dtype, device=emb.device)

    def forward(self, inputs_embeds: torch.Tensor, attn_mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
        """``gemma_apply``: inputs_embeds [B, T, D] -> final hidden [B, T, D].
        attn_mask [B, T] (nonzero = valid) is a key mask; without one every
        token attends to every token (PaliGemma's prefix-LM inference mask)."""
        b, t, _ = inputs_embeds.shape
        if attn_mask is None:
            positions = torch.arange(t, device=inputs_embeds.device).expand(b, t)
            key_mask = None
        else:
            positions = torch.cumsum(attn_mask.long(), dim=-1) - 1
            key_mask = attn_mask > 0
        x = inputs_embeds
        for layer in self.layers:
            x = layer(x, positions, key_mask, causal)
        return rms_norm(self.final_norm, x, self.cfg.rms_eps)
