"""Dual-encoder towers (``clip`` style) as ``nn.Module``s.

Counterpart of ``multimodal_embedding_tpu/models/towers.py`` for the CLIP
family (OpenAI-CLIP-L and the debug stand-in): class token + learned
positions, pre-layernorm encoder, CLS pooling through a final layernorm and
a linear projection; a causal text tower pooled at the EOS position.

Patchification is a reshape + matmul, as in the JAX package: a ``conv2d``
on the card would go through cuDNN in TF32 by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
from torch import nn

from .layers import Encoder, LayerNorm

Style = Literal["clip", "siglip"]


@dataclass(frozen=True)
class VisionConfig:
    image_size: int
    patch_size: int
    dim: int
    layers: int
    heads: int
    mlp_dim: int
    proj_dim: int | None  # None => pooled output is the embedding (siglip)
    style: Style = "clip"
    act: str = "quick_gelu"
    ln_eps: float = 1e-5
    use_head: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int
    max_len: int
    dim: int
    layers: int
    heads: int
    mlp_dim: int
    proj_dim: int | None
    style: Style = "clip"
    act: str = "quick_gelu"
    ln_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class DualEncoderConfig:
    vision: VisionConfig
    text: TextConfig
    family: Style = "clip"


def _normal(shape, std: float, gen: torch.Generator, device, dtype) -> nn.Parameter:
    t = torch.randn(shape, generator=gen, device=device) * std
    return nn.Parameter(t.to(dtype), requires_grad=False)


def _require_clip(style: str) -> None:
    if style != "clip":
        raise NotImplementedError(f"the {style!r} tower style is not yet ported")


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, patch*patch*3] with (ph, pw, c) flatten order;
    non-divisible sizes crop the trailing pixels (a stride=patch conv)."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x[:, : gh * patch, : gw * patch]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        _require_clip(cfg.style)
        self.cfg = cfg
        n_tok = cfg.n_patches + 1
        self.patch = nn.ParameterDict({"w": _normal((cfg.patch_size**2 * 3, cfg.dim), 0.02, gen, device, dtype)})
        self.pos = _normal((n_tok, cfg.dim), 0.02, gen, device, dtype)
        self.encoder = Encoder(cfg.layers, cfg.dim, cfg.heads, cfg.mlp_dim, cfg.act, cfg.ln_eps,
                               gen=gen, device=device, dtype=dtype)
        self.post_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        self.cls = _normal((cfg.dim,), 0.02, gen, device, dtype)
        self.pre_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        self.proj = _normal((cfg.dim, cfg.proj_dim), cfg.dim**-0.5, gen, device, dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, S, 3] (normalized) -> unnormalized embeddings [B, E] f32."""
        w = self.patch["w"]
        dtype = w.dtype
        x = torch.matmul(patchify(pixels.to(dtype), self.cfg.patch_size), w)
        cls = self.cls.to(dtype).expand(x.shape[0], 1, self.cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos.to(dtype)
        x = self.pre_ln(x)
        x = self.encoder(x)
        pooled = self.post_ln(x[:, 0])
        return torch.matmul(pooled.float(), self.proj.float())


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        _require_clip(cfg.style)
        self.cfg = cfg
        self.tok = _normal((cfg.vocab_size, cfg.dim), 0.02, gen, device, dtype)
        self.pos = _normal((cfg.max_len, cfg.dim), 0.02, gen, device, dtype)
        self.encoder = Encoder(cfg.layers, cfg.dim, cfg.heads, cfg.mlp_dim, cfg.act, cfg.ln_eps,
                               gen=gen, device=device, dtype=dtype)
        self.final_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        self.proj = _normal((cfg.dim, cfg.proj_dim), cfg.dim**-0.5, gen, device, dtype)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, T] -> unnormalized embeddings [B, E] f32."""
        t = input_ids.shape[1]
        x = (self.tok[input_ids] + self.pos[:t]).to(self.tok.dtype)
        x = self.encoder(x, causal=True, mask=attn_mask)
        x = self.final_ln(x)
        # EOS pooling as in HF CLIPTextTransformer: configs with the legacy
        # eos_token_id == 2 pool at argmax(input_ids) (the real EOS, 49407,
        # is the highest vocab id); newer configs pool at the first
        # occurrence of eos_token_id
        if self.cfg.eos_token_id == 2:
            eos_pos = torch.argmax(input_ids, dim=-1)
        else:
            eos_pos = torch.argmax((input_ids == self.cfg.eos_token_id).int(), dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        return torch.matmul(pooled.float(), self.proj.float())


class DualEncoder(nn.Module):
    """Image and text towers; weights drawn from ``torch.Generator(seed)``."""

    def __init__(self, cfg: DualEncoderConfig, *, seed: int = 0, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.vision = VisionTower(cfg.vision, gen=gen, device=device, dtype=dtype)
        self.text = TextTower(cfg.text, gen=gen, device=device, dtype=dtype)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def encode_text(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.text(input_ids, attn_mask)
