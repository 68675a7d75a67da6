"""Model loading: HF checkpoints, tokenizers and the offline debug models.

Counterpart of ``multimodal_embedding_tpu/models/zoo.py``. A ``LoadedModel``
carries everything the encoding engine needs: the model (a ``DualEncoder``,
a ``ColPali`` or a ``JinaClip``), the preprocessing recipe and a tokenize
callable. Two ways to build one:

- :func:`load_model` reads an HF checkpoint (config.json and weights) from
  the local transformers cache or a directory, converts it into the JAX
  package's param tree (``models/convert.py``) and loads that into the
  module (``models/params.py``); with ``native_cache_dir`` the converted
  tree is kept as a ``.npz`` and reloaded without transformers. The CLI
  skips a model whose load fails, as the reference does (main.py:822-824).
- :func:`load_debug_model`: a small random-init stand-in with the word-hash
  tokenizer, for offline runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
from .params import load_tree
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


def hf_tokenizer(info: ModelInfo):
    """Tokenize with the model's own HF tokenizer (from the HF cache).

    Pads to ``info.text_max_len`` (SigLIP: 64, like its HF processor). The
    reference pads CLIP with ``padding=True`` (main.py:427); a fixed length
    gives the same embeddings, since CLIP pools at the EOS position and its
    causal attention keeps later pads from reaching it. ColPali does not
    come through here (its prompt wrapping is ``colpali_processing.py``'s).
    """
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(info.hf_id, trust_remote_code=info.trust_remote_code)

    def tokenize(texts: list[str]):
        out = tok(texts, padding="max_length", truncation=True, max_length=info.text_max_len, return_tensors="np")
        mask = out.get("attention_mask")
        return out["input_ids"].astype(np.int32), None if mask is None else mask.astype(np.int32)

    return tokenize


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


# --- real checkpoint loading --------------------------------------------------


def dual_encoder_from_params(tree, cfg: DualEncoderConfig, *, device, dtype=torch.float32) -> DualEncoder:
    """A ``DualEncoder`` holding a converted param tree's weights in ``dtype``
    (built on ``meta``: the tree's tensors are the only copy on ``device``)."""
    return load_tree(DualEncoder(cfg, device="meta", dtype=dtype), tree, dtype, device=device)


def load_model(
    info: ModelInfo,
    *,
    device,
    dtype=torch.bfloat16,
    checkpoint_dir: str | None = None,
    native_cache_dir: str | None = None,
) -> LoadedModel:
    """Load and convert an HF checkpoint (the HF cache, or ``checkpoint_dir``).

    Dense and siglip models: with ``native_cache_dir``, the converted f32
    tree and its config are written there as ``<name>.npz`` on the first
    load (before the cast to ``dtype``) and read back on later loads
    without transformers' model classes (``models/checkpoint.py``). ColPali
    and Jina-CLIP go to their own loaders.
    """
    if native_cache_dir and info.type in ("dense", "siglip"):
        from pathlib import Path

        from .checkpoint import load_params

        npz = Path(native_cache_dir) / f"{info.name}.npz"
        if npz.exists():
            tree, cfg = load_params(npz)
            return LoadedModel(info=info, cfg=cfg, model=dual_encoder_from_params(tree, cfg, device=device, dtype=dtype),
                               preprocess=info.preprocess, tokenize=hf_tokenizer(info))
    if info.type == "colpali":
        from .colpali import load_colpali

        return load_colpali(info, device=device, dtype=dtype, checkpoint_dir=checkpoint_dir)
    if info.type == "jina":
        from .jina import load_jina

        return load_jina(info, device=device, dtype=dtype, checkpoint_dir=checkpoint_dir)

    from .convert import clip_config_from_hf, clip_params_from_hf, siglip_config_from_hf, siglip_params_from_hf

    src = checkpoint_dir or info.hf_id
    if info.type == "siglip":
        from transformers import SiglipModel

        hf = SiglipModel.from_pretrained(src, torch_dtype=torch.float32)
        cfg = siglip_config_from_hf(hf.config)
        tree = siglip_params_from_hf(hf.state_dict(), cfg)
    else:
        from transformers import CLIPModel

        hf = CLIPModel.from_pretrained(src, torch_dtype=torch.float32, trust_remote_code=info.trust_remote_code)
        cfg = clip_config_from_hf(hf.config)
        tree = clip_params_from_hf(hf.state_dict(), cfg)
    del hf
    if native_cache_dir:
        from pathlib import Path

        from .checkpoint import save_params

        save_params(Path(native_cache_dir) / f"{info.name}.npz", tree, cfg)
    return LoadedModel(info=info, cfg=cfg, model=dual_encoder_from_params(tree, cfg, device=device, dtype=dtype),
                       preprocess=info.preprocess, tokenize=hf_tokenizer(info))


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
