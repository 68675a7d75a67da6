"""Dual-encoder towers as ``nn.Module``s.

Counterpart of ``multimodal_embedding_tpu/models/towers.py`` for:
- the ``clip`` style (OpenAI-CLIP-L and the debug stand-in): class token +
  learned positions, pre-layernorm encoder, CLS pooling through a final
  layernorm and a linear projection; a causal text tower pooled at the EOS
  position;
- the ``siglip`` style (SigLIP-So400m, SigLIP-Base, and the vision tower
  inside ColPali's PaliGemma): patch bias, no class token, no pre-layernorm,
  a post-layernorm over all tokens, then the MAP attention-pooling head (a
  learned probe cross-attending to the sequence, a LayerNorm and an MLP
  residual) or, headless (``use_head=False``), the ``[B, N, D]`` sequence
  itself; a bidirectional text tower with a key mask, pooled at the last
  token through a ``head`` linear.

Patchification is a reshape + matmul, as in the JAX package: a ``conv2d``
on the card would go through cuDNN in TF32 by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
from torch import nn

from ..utils import graphs
from ..utils.graphs import ShapeGraphs
from .layers import MLP, Encoder, LayerNorm, Linear, MultiHeadAttention

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


def seeded_generator(seed: int, device) -> torch.Generator | None:
    """The generator a model's random init draws from; none on the ``meta``
    device, where a module holds shapes only (its weights come from
    ``load_state_dict``)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _require_style(style: str) -> None:
    if style not in ("clip", "siglip"):
        raise ValueError(f"tower style must be 'clip' or 'siglip', not {style!r}")


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
        _require_style(cfg.style)
        self.cfg = cfg
        clip = cfg.style == "clip"
        n_tok = cfg.n_patches + (1 if clip else 0)
        self.patch = nn.ParameterDict({"w": _normal((cfg.patch_size**2 * 3, cfg.dim), 0.02, gen, device, dtype)})
        if not clip:
            self.patch["b"] = nn.Parameter(torch.zeros(cfg.dim, device=device, dtype=dtype), requires_grad=False)
        self.pos = _normal((n_tok, cfg.dim), 0.02, gen, device, dtype)
        self.encoder = Encoder(cfg.layers, cfg.dim, cfg.heads, cfg.mlp_dim, cfg.act, cfg.ln_eps,
                               gen=gen, device=device, dtype=dtype)
        self.post_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        if clip:
            self.cls = _normal((cfg.dim,), 0.02, gen, device, dtype)
            self.pre_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        elif cfg.use_head:
            # the MAP head, named as the JAX package's ``head`` subtree
            self.head = nn.Module()
            self.head.probe = _normal((1, 1, cfg.dim), 0.02, gen, device, dtype)
            self.head.attn = MultiHeadAttention(cfg.dim, cfg.heads, gen=gen, device=device, dtype=dtype)
            self.head.ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
            self.head.mlp = MLP(cfg.dim, cfg.mlp_dim, cfg.act, gen=gen, device=device, dtype=dtype)
        if clip or (cfg.use_head and cfg.proj_dim is not None):
            self.proj = _normal((cfg.dim, cfg.proj_dim), cfg.dim**-0.5, gen, device, dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, S, 3] (normalized) -> clip and siglip with its head:
        unnormalized embeddings [B, E] f32; headless siglip: the
        post-layernorm patch sequence [B, N, D] in the tower's dtype."""
        w = self.patch["w"]
        dtype = w.dtype
        x = torch.matmul(patchify(pixels.to(dtype), self.cfg.patch_size), w)
        if self.cfg.style == "siglip":
            x = self.encoder((x + self.patch["b"]) + self.pos.to(dtype))
            x = self.post_ln(x)
            if not self.cfg.use_head:
                return x
            return self._map_head(x)
        cls = self.cls.to(dtype).expand(x.shape[0], 1, self.cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos.to(dtype)
        x = self.pre_ln(x)
        x = self.encoder(x)
        pooled = self.post_ln(x[:, 0])
        return torch.matmul(pooled.float(), self.proj.float())

    def _map_head(self, x: torch.Tensor) -> torch.Tensor:
        """Attention pooling: the probe cross-attends to the post-layernorm
        sequence [B, N, D] (through the attention kernel on the card, one
        query row over N keys), then an MLP residual; the pooled row,
        projected when the config has a ``proj_dim``, as f32 [B, E]."""
        head = self.head
        probe = head.probe.to(x.dtype).expand(x.shape[0], 1, self.cfg.dim)
        h = head.attn(probe, kv=x)
        h = h + head.mlp(head.ln(h))
        pooled = h[:, 0]
        if self.cfg.proj_dim is not None:
            return torch.matmul(pooled.float(), self.proj.float())
        return pooled.float()


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        _require_style(cfg.style)
        self.cfg = cfg
        self.tok = _normal((cfg.vocab_size, cfg.dim), 0.02, gen, device, dtype)
        self.pos = _normal((cfg.max_len, cfg.dim), 0.02, gen, device, dtype)
        self.encoder = Encoder(cfg.layers, cfg.dim, cfg.heads, cfg.mlp_dim, cfg.act, cfg.ln_eps,
                               gen=gen, device=device, dtype=dtype)
        self.final_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        if cfg.style == "clip":
            self.proj = _normal((cfg.dim, cfg.proj_dim), cfg.dim**-0.5, gen, device, dtype)
        else:
            self.head = Linear(cfg.dim, cfg.dim, gen=gen, device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, T] -> unnormalized embeddings [B, E] f32. clip:
        causal, pooled at the EOS position through ``proj``; siglip:
        bidirectional, pooled at the last position through ``head``."""
        t = input_ids.shape[1]
        x = (self.tok[input_ids] + self.pos[:t]).to(self.tok.dtype)
        x = self.encoder(x, causal=self.cfg.style == "clip", mask=attn_mask)
        x = self.final_ln(x)
        if self.cfg.style == "siglip":
            return self.head(x[:, -1]).float()
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
        gen = seeded_generator(seed, device)
        self.vision = VisionTower(cfg.vision, gen=gen, device=device, dtype=dtype)
        self.text = TextTower(cfg.text, gen=gen, device=device, dtype=dtype)
        self.text_graphs = ShapeGraphs()

    def _apply(self, fn, *args, **kwargs):
        self.text_graphs.reset()  # the graphs read the tensors about to move
        return super()._apply(fn, *args, **kwargs)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def encode_text(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        """The text tower; its batches on the card run as CUDA graphs
        (``utils/graphs.py``)."""
        if graphs.applies(input_ids):
            return self.text_graphs(self.text, input_ids, attn_mask)
        return self.text(input_ids, attn_mask)
