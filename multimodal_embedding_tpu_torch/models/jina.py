"""Jina-CLIP-v1: an EVA02-B/16 vision tower and a JinaBERT text tower, as
``nn.Module``s (forward and random init).

Counterpart of ``multimodal_embedding_tpu/models/jina.py``:
- Vision (EVA02-B/16): class token, learned positions; each block a
  pre-LayerNorm, q/k/v projections with q and v biases only, 2D axial rotary
  embeddings on the patch tokens (the class token unrotated), a sub-LayerNorm
  after attention, a SwiGLU MLP with an inner LayerNorm; a final LayerNorm,
  CLS pooling through ``proj`` (plus ``proj_b`` where the weights carry one).
- Text (JinaBERT): BERT post-norm blocks with no position embeddings but
  symmetric ALiBi biases, ``-1e30`` key masking, a gated GELU feed-forward;
  mask-weighted mean pooling, then ``proj`` where the config has one.

Attention in both towers is the JAX package's inline einsum (f32 logits and
softmax, rope or ALiBi): it has no kernel route there, so here it is plain
PyTorch on every device. Parameter names follow the JAX param tree, with the
``blocks`` stacks unrolled (``models/params.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .layers import LayerNorm, Linear
from .towers import _normal, patchify

# --- configs -------------------------------------------------------------------


@dataclass(frozen=True)
class Eva02Config:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 2048  # SwiGLU hidden (mlp_ratio 8/3)
    proj_dim: int = 768
    ln_eps: float = 1e-6
    rope_theta: float = 10000.0  # VisionRotaryEmbeddingFast default
    rope_pt_grid: int = 16  # pt_seq_len: pretrain grid positions are rescaled to this

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class JinaBertConfig:
    vocab_size: int = 30528
    dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    ln_eps: float = 1e-12
    proj_dim: int | None = None  # v1 uses the raw mean-pooled 768


@dataclass(frozen=True)
class JinaClipConfig:
    vision: Eva02Config
    text: JinaBertConfig


# --- EVA02 vision tower ----------------------------------------------------------


def _vision_rope_2d(grid: int, head_dim: int, theta: float, pt_grid: int = 16, *, device="cpu"):
    """2D axial rope angle tables of EVA-02's VisionRotaryEmbeddingFast (built
    with ``dim = head_dim // 2``): per-axis frequencies theta^(-2j / (head_dim/2)),
    positions rescaled to the pretrain grid, each angle repeated for an
    interleaved pair, the row-axis block then the column-axis block.
    Returns (cos, sin), each f32 [grid*grid, head_dim]."""
    rot = head_dim // 2
    freqs = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32, device=device)[: rot // 2] / rot)
    t = torch.arange(grid, dtype=torch.float32, device=device) / grid * pt_grid
    ang = (t[:, None] * freqs[None, :]).repeat_interleave(2, dim=-1)  # [grid, rot]
    row = ang[:, None, :].expand(grid, grid, rot)
    col = ang[None, :, :].expand(grid, grid, rot)
    angles = torch.cat([row, col], dim=-1).reshape(grid * grid, head_dim)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """EVA rotate_half: interleaved pairs (x0, x1) -> (-x1, x0)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x = torch.stack([-x[..., 1], x[..., 0]], dim=-1)
    return x.reshape(*x.shape[:-2], -1)


def _apply_rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, Dh] -> x*cos + rotate_half(x)*sin over the full head dim,
    in f32, returned in x's dtype."""
    xf = x.float()
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (xf * c + _rotate_half_interleaved(xf) * s).to(x.dtype)


def _softmax_attention(q, k, v, bias: torch.Tensor | None = None,
                       key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [B, T, H, Dh] -> [B, T, H*Dh]: f32 logits over sqrt(Dh), plus
    ``bias`` [H, T, T] (ALiBi), invalid keys of ``key_mask`` [B, T] set to
    the finite -1e30; f32 softmax cast to v's dtype, PV accumulated in f32."""
    b, t, h, dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], -1e30)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
    return o.to(v.dtype).reshape(b, t, h * dh)


class _Weight(nn.Module):
    """A bias-free projection's weight ``w`` [d_in, d_out] (the JAX layout).
    ``x @ w`` accumulates in f32 and comes back in x's dtype: in bf16 one
    rounding before JinaBERT's f32 gated GELU, where the JAX package keeps
    the f32 product."""

    def __init__(self, d_in: int, d_out: int, *, gen, device, dtype):
        super().__init__()
        self.w = _normal((d_in, d_out), 0.02, gen, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w)


class _Eva02Block(nn.Module):
    def __init__(self, cfg: Eva02Config, *, gen, device, dtype):
        super().__init__()
        d, eps = cfg.dim, cfg.ln_eps
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.ln1 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.attn = nn.Module()
        self.attn.q, self.attn.k, self.attn.v = Linear(d, d, **kw), _Weight(d, d, **kw), Linear(d, d, **kw)
        self.attn.inner_ln = LayerNorm(d, eps, device=device, dtype=dtype)
        self.attn.o = Linear(d, d, **kw)
        self.ln2 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.mlp = nn.Module()
        self.mlp.w1, self.mlp.w2 = Linear(d, cfg.mlp_dim, **kw), Linear(d, cfg.mlp_dim, **kw)
        self.mlp.ffn_ln = LayerNorm(cfg.mlp_dim, eps, device=device, dtype=dtype)
        self.mlp.w3 = Linear(cfg.mlp_dim, d, **kw)
        self.heads = cfg.heads

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        a, m = self.attn, self.mlp
        b, n, _ = h.shape
        y = self.ln1(h)
        q = a.q(y).reshape(b, n, self.heads, -1)
        k = a.k(y).reshape(b, n, self.heads, -1)
        v = a.v(y).reshape(b, n, self.heads, -1)
        # rope on the patch tokens only (the class token unrotated)
        q = torch.cat([q[:, :1], _apply_rope_2d(q[:, 1:], cos, sin)], dim=1)
        k = torch.cat([k[:, :1], _apply_rope_2d(k[:, 1:], cos, sin)], dim=1)
        o = a.o(a.inner_ln(_softmax_attention(q, k, v)))  # sub-LN before the output projection
        h = h + o
        y = self.ln2(h)
        hidden = (torch.nn.functional.silu(m.w1(y).float()) * m.w2(y).float()).to(h.dtype)
        return h + m.w3(m.ffn_ln(hidden))


class Eva02Tower(nn.Module):
    def __init__(self, cfg: Eva02Config, *, gen: torch.Generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.patch = nn.ParameterDict({
            "w": _normal((cfg.patch_size**2 * 3, d), 0.02, gen, device, dtype),
            "b": nn.Parameter(torch.zeros(d, device=device, dtype=dtype), requires_grad=False),
        })
        self.cls = _normal((d,), 0.02, gen, device, dtype)
        self.pos = _normal((cfg.grid**2 + 1, d), 0.02, gen, device, dtype)
        self.blocks = nn.ModuleList(_Eva02Block(cfg, gen=gen, device=device, dtype=dtype) for _ in range(cfg.layers))
        self.final_ln = LayerNorm(d, cfg.ln_eps, device=device, dtype=dtype)
        self.proj = _normal((d, cfg.proj_dim), d**-0.5, gen, device, dtype)
        # the EVA02 head's bias, [proj_dim]: none in a random init; set it
        # (an nn.Parameter) before loading weights that carry one
        self.proj_b: nn.Parameter | None = None
        cos, sin = _vision_rope_2d(cfg.grid, d // cfg.heads, cfg.rope_theta, cfg.rope_pt_grid, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, S, 3] (normalized) -> unnormalized embeddings [B, proj_dim] f32."""
        w = self.patch["w"]
        dtype = w.dtype
        x = torch.matmul(patchify(pixels.to(dtype), self.cfg.patch_size), w) + self.patch["b"]
        cls = self.cls.to(dtype).expand(x.shape[0], 1, self.cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos.to(dtype)
        for block in self.blocks:
            x = block(x, self.rope_cos, self.rope_sin)
        pooled = self.final_ln(x)[:, 0]
        out = torch.matmul(pooled.float(), self.proj.float())
        if self.proj_b is not None:
            out = out + self.proj_b.float()
        return out


# --- JinaBERT text tower ----------------------------------------------------------


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Standard ALiBi geometric slopes (Press et al.)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    slopes = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(slopes + extra, np.float32)


class _JinaBertBlock(nn.Module):
    def __init__(self, cfg: JinaBertConfig, *, gen, device, dtype):
        super().__init__()
        d, eps = cfg.dim, cfg.ln_eps
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.attn = nn.Module()
        self.attn.q, self.attn.k, self.attn.v, self.attn.o = (Linear(d, d, **kw) for _ in range(4))
        self.attn_ln = LayerNorm(d, eps, device=device, dtype=dtype)
        self.mlp = nn.Module()
        self.mlp.gated = _Weight(d, 2 * cfg.mlp_dim, **kw)  # [gate | up], no bias
        self.mlp.out = Linear(cfg.mlp_dim, d, **kw)
        self.mlp_ln = LayerNorm(d, eps, device=device, dtype=dtype)
        self.heads = cfg.heads

    def forward(self, h: torch.Tensor, alibi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        a, m = self.attn, self.mlp
        b, t, _ = h.shape
        q, k, v = (p(h).reshape(b, t, self.heads, -1) for p in (a.q, a.k, a.v))
        h = self.attn_ln(h + a.o(_softmax_attention(q, k, v, alibi, mask)))  # post-norm
        g, u = m.gated(h).float().chunk(2, dim=-1)
        ff = (torch.nn.functional.gelu(g, approximate="none") * u).to(h.dtype)
        return self.mlp_ln(h + m.out(ff))


class JinaBertTower(nn.Module):
    def __init__(self, cfg: JinaBertConfig, *, gen: torch.Generator, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.tok = _normal((cfg.vocab_size, cfg.dim), 0.02, gen, device, dtype)
        self.emb_ln = LayerNorm(cfg.dim, cfg.ln_eps, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(_JinaBertBlock(cfg, gen=gen, device=device, dtype=dtype)
                                    for _ in range(cfg.layers))
        if cfg.proj_dim is not None:
            self.proj = _normal((cfg.dim, cfg.proj_dim), cfg.dim**-0.5, gen, device, dtype)
        self.register_buffer("slopes", torch.from_numpy(alibi_slopes(cfg.heads)).to(device), persistent=False)

    def forward(self, input_ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, T] -> mean-pooled embeddings [B, dim or proj_dim] f32 (unnormalized)."""
        b, t = input_ids.shape
        if mask is None:
            mask = torch.ones(b, t, dtype=torch.int32, device=input_ids.device)
        x = self.emb_ln(self.tok[input_ids])
        pos = torch.arange(t, device=x.device)
        dist = (pos[:, None] - pos[None, :]).abs().float()
        alibi = -self.slopes[:, None, None] * dist[None]  # [H, T, T]
        for block in self.blocks:
            x = block(x, alibi, mask)
        m = mask.float()[:, :, None]
        pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        if self.cfg.proj_dim is not None:
            pooled = torch.matmul(pooled, self.proj.float())
        return pooled


# --- assembly ---------------------------------------------------------------------


class JinaClip(nn.Module):
    """Both towers; weights drawn from ``torch.Generator(seed)``."""

    def __init__(self, cfg: JinaClipConfig, *, seed: int = 0, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.vision = Eva02Tower(cfg.vision, gen=gen, device=device, dtype=dtype)
        self.text = JinaBertTower(cfg.text, gen=gen, device=device, dtype=dtype)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def encode_text(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.text(input_ids, attn_mask)


def debug_jina_config() -> JinaClipConfig:
    return JinaClipConfig(
        vision=Eva02Config(image_size=32, patch_size=16, dim=32, layers=2, heads=4, mlp_dim=40, proj_dim=24),
        text=JinaBertConfig(vocab_size=256, dim=32, layers=2, heads=4, mlp_dim=64, proj_dim=24),
    )


def load_debug_jina(info, seed: int = 0, *, device, dtype=torch.float32):
    """Random-init small Jina-CLIP (32 px images, 4 patches) for offline runs."""
    from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
    from .zoo import LoadedModel, hash_tokenizer

    cfg = debug_jina_config()
    return LoadedModel(
        info=info,
        cfg=cfg,
        model=JinaClip(cfg, seed=seed, device=device, dtype=dtype),
        preprocess=PreprocessConfig(image_size=cfg.vision.image_size, resize_mode="exact",
                                    mean=SIGLIP_MEAN, std=SIGLIP_STD),
        tokenize=hash_tokenizer(cfg.text.vocab_size, 32, cfg.text.vocab_size - 1),
        weights_provenance="debug-random",
    )
