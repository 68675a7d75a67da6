"""ColPali: the PaliGemma-based multi-vector late-interaction retriever.

Counterpart of ``multimodal_embedding_tpu/models/colpali.py``:

- vision: the headless SigLIP tower (``towers.py``, ``use_head=False``) ->
  [B, N, Dv];
- multimodal projector: a linear to the Gemma width, its bias added before
  the cast to the model dtype (HF PaliGemma's 1/sqrt(dim) on image features
  cancels Gemma's sqrt(dim) on the merged embeddings, so image features
  enter the decoder at projector scale; text embeddings carry the scale);
- language model: Gemma (``gemma.py``) over [image features | prompt suffix]
  with PaliGemma's inference mask (every token attends to every valid token);
- retrieval head: a linear to 128 dims per token in f32, L2-normalized per
  token with ``max(norm, 1e-12)``; query pad tokens are zeroed (HF
  ColPaliForRetrieval's ``emb * mask``, COMPAT #8).

Scoring runs MaxSim without masks: a zero pad vector adds a 0 floor to the
doc-token max and exactly 0 to the query sum. HF checkpoint conversion and
``load_colpali`` are not yet ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
from .gemma import Gemma, GemmaConfig
from .layers import linear
from .registry import ModelInfo
from .towers import VisionConfig, VisionTower


@dataclass(frozen=True)
class ColPaliConfig:
    vision: VisionConfig
    gemma: GemmaConfig
    embedding_dim: int = 128
    image_token_id: int = 256000


def _normalize_tokens(out: torch.Tensor) -> torch.Tensor:
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


class ColPali(nn.Module):
    """``vision``, ``mm_proj.{w,b}``, ``gemma``, ``emb_proj.{w,b}`` and the
    integer buffer ``image_suffix_ids`` (the image prompt's tokens, e.g.
    "<bos>Describe the image.\\n"); weights drawn from
    ``torch.Generator(seed)`` on ``device``."""

    def __init__(self, cfg: ColPaliConfig, image_suffix_ids, *, seed: int = 0, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape):
            t = torch.randn(shape, generator=gen, device=device) * 0.02
            return nn.Parameter(t.to(dtype), requires_grad=False)

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device, dtype=dtype), requires_grad=False)

        self.vision = VisionTower(cfg.vision, gen=gen, device=device, dtype=dtype)
        self.mm_proj = nn.ParameterDict({"w": normal((cfg.vision.dim, cfg.gemma.dim)), "b": zeros(cfg.gemma.dim)})
        self.gemma = Gemma(cfg.gemma, gen=gen, device=device, dtype=dtype)
        self.emb_proj = nn.ParameterDict({"w": normal((cfg.gemma.dim, cfg.embedding_dim)),
                                          "b": zeros(cfg.embedding_dim)})
        ids = torch.as_tensor(np.asarray(image_suffix_ids, np.int32), device=device)
        self.register_buffer("image_suffix_ids", ids)

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The 128-d head in f32, then per-token L2 normalization."""
        out = torch.matmul(hidden.float(), self.emb_proj["w"].float()) + self.emb_proj["b"].float()
        return _normalize_tokens(out)

    def image_fwd(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, S, 3] -> per-token embeddings [B, N + L_suffix, D] f32."""
        dtype = self.mm_proj["w"].dtype
        feats = self.vision(pixels).to(dtype)  # [B, N, Dv]
        proj = linear(feats, self.mm_proj["w"], self.mm_proj["b"])
        b = pixels.shape[0]
        suffix = self.gemma.embed_tokens(self.image_suffix_ids.expand(b, -1))
        hidden = self.gemma(torch.cat([proj, suffix.to(dtype)], dim=1))
        return self._head(hidden)

    def text_fwd(self, input_ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, T] -> per-token embeddings [B, T, D] f32, pad tokens
        exact zeros."""
        if mask is None:
            mask = torch.ones_like(input_ids)
        hidden = self.gemma(self.gemma.embed_tokens(input_ids), attn_mask=mask)
        return self._head(hidden) * mask[:, :, None].float()

    # the encoding engine's interface (models/encode.py)
    encode_image = image_fwd
    encode_text = text_fwd


def debug_colpali_config(image_size: int = 28) -> ColPaliConfig:
    return ColPaliConfig(
        vision=VisionConfig(
            image_size=image_size, patch_size=14, dim=32, layers=2, heads=4, mlp_dim=64,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6, use_head=False,
        ),
        gemma=GemmaConfig(vocab_size=512, dim=48, layers=2, heads=4, kv_heads=1, head_dim=16, mlp_dim=96),
        embedding_dim=16,
        image_token_id=500,
    )


def load_debug_colpali(info: ModelInfo, seed: int = 0, *, device, dtype=torch.float32):
    """Random-init small ColPali (28 px images, 4 patches) for offline runs."""
    from .zoo import LoadedModel, hash_tokenizer

    cfg = debug_colpali_config()
    pre = PreprocessConfig(image_size=cfg.vision.image_size, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD)
    return LoadedModel(
        info=info,
        cfg=cfg,
        model=ColPali(cfg, np.array([1, 7, 8, 9], np.int32), seed=seed, device=device, dtype=dtype),
        preprocess=pre,
        tokenize=hash_tokenizer(cfg.gemma.vocab_size, 16, cfg.gemma.vocab_size - 1),
        multi_vector=True,
        weights_provenance="debug-random",
    )
