"""Loaded-model bundle, tokenizers and the offline debug models.

Counterpart of ``multimodal_embedding_tpu/models/zoo.py``. A ``LoadedModel``
carries everything the encoding engine needs: the model (a ``DualEncoder``,
a ``ColPali`` or a ``JinaClip``), the preprocessing recipe and a tokenize
callable. Loading real HF checkpoints is not yet ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
from .registry import ModelInfo
from .towers import DualEncoder, DualEncoderConfig, TextConfig, VisionConfig

if TYPE_CHECKING:
    from .colpali import ColPali, ColPaliConfig
    from .jina import JinaClip, JinaClipConfig


@dataclass
class LoadedModel:
    info: ModelInfo
    cfg: DualEncoderConfig | ColPaliConfig | JinaClipConfig
    model: DualEncoder | ColPali | JinaClip
    preprocess: PreprocessConfig
    tokenize: Callable[[list[str]], tuple[np.ndarray, np.ndarray]]
    # multi-vector models (ColPali) return per-token embeddings [N, T, D],
    # scored by MaxSim; dense models one vector per item
    multi_vector: bool = False
    # Provenance of the weights, stamped into every result CSV ("real" =
    # converted HF checkpoint; "arch-random"/"debug-random" = random init,
    # throughput-valid but accuracy-meaningless).
    weights_provenance: str = "real"


def hash_tokenizer(vocab_size: int, max_len: int, eos_id: int):
    """Word-hash tokenizer for offline debug models. Like the JAX package's,
    it uses Python's ``hash``, which is salted per process: ids are the same
    within a process (so both packages agree), not across processes unless
    ``PYTHONHASHSEED`` is set."""

    def tokenize(texts: list[str]):
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split()[: max_len - 2]
            toks = [1] + [2 + (hash(w) % (vocab_size - 3)) for w in words] + [eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    return tokenize


def debug_dual_config(family: str, image_size: int = 64) -> DualEncoderConfig:
    style = "siglip" if family in ("siglip", "colpali") else "clip"
    vocab = 512
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=image_size,
            patch_size=16,
            dim=64,
            layers=2,
            heads=4,
            mlp_dim=128,
            proj_dim=32 if style == "clip" else None,
            style=style,
            act="quick_gelu" if style == "clip" else "gelu_pytorch_tanh",
        ),
        text=TextConfig(
            vocab_size=vocab,
            max_len=64,
            dim=64,
            layers=2,
            heads=4,
            mlp_dim=128,
            proj_dim=32 if style == "clip" else 64,
            style=style,
            act="quick_gelu" if style == "clip" else "gelu_pytorch_tanh",
            eos_token_id=vocab - 1,
        ),
        family=style,
    )


def debug_preprocess(cfg: DualEncoderConfig) -> PreprocessConfig:
    """The debug models' preprocessing: exact resize to the tiny tower size."""
    return PreprocessConfig(
        image_size=cfg.vision.image_size, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD,
    )


def load_debug_model(info: ModelInfo, seed: int = 0, *, device, dtype=torch.float32) -> LoadedModel:
    """Random-init small model (64 px images; ColPali 28 px, Jina 32 px) for
    offline runs."""
    if info.type == "colpali":
        from .colpali import load_debug_colpali

        return load_debug_colpali(info, seed=seed, device=device, dtype=dtype)
    if info.type == "jina":
        from .jina import load_debug_jina

        return load_debug_jina(info, seed=seed, device=device, dtype=dtype)
    cfg = debug_dual_config(info.type)
    return LoadedModel(
        info=info,
        cfg=cfg,
        model=DualEncoder(cfg, seed=seed, device=device, dtype=dtype),
        preprocess=debug_preprocess(cfg),
        tokenize=hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, cfg.text.eos_token_id),
        weights_provenance="debug-random",
    )
