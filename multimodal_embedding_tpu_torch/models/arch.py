"""Full-scale architecture configs, for runs without checkpoint weights.

Counterpart of ``multimodal_embedding_tpu/models/arch.py``: the architecture,
and so the performance envelope, of the HF checkpoint the reference loads;
only the weights are random. Sources: the HF config.json of each model id.
"""

from __future__ import annotations

import numpy as np
import torch

from .towers import DualEncoder, DualEncoderConfig, TextConfig, VisionConfig


def _clip(
    *, img: int, v_dim: int, v_layers: int, v_heads: int, v_mlp: int, patch: int,
    t_dim: int, t_layers: int, t_heads: int, t_mlp: int, proj: int, act: str,
) -> DualEncoderConfig:
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=img, patch_size=patch, dim=v_dim, layers=v_layers, heads=v_heads,
            mlp_dim=v_mlp, proj_dim=proj, style="clip", act=act,
        ),
        text=TextConfig(
            vocab_size=49408, max_len=77, dim=t_dim, layers=t_layers, heads=t_heads,
            mlp_dim=t_mlp, proj_dim=proj, style="clip", act=act, eos_token_id=2,
        ),
        family="clip",
    )


def _vit_h(img: int, act: str) -> DualEncoderConfig:
    return _clip(
        img=img, v_dim=1280, v_layers=32, v_heads=16, v_mlp=5120, patch=14,
        t_dim=1024, t_layers=24, t_heads=16, t_mlp=4096, proj=1024, act=act,
    )


def _siglip(*, img: int, patch: int, dim: int, layers: int, heads: int, mlp: int) -> DualEncoderConfig:
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=img, patch_size=patch, dim=dim, layers=layers, heads=heads, mlp_dim=mlp,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
        ),
        text=TextConfig(
            vocab_size=32000, max_len=64, dim=dim, layers=layers, heads=heads, mlp_dim=mlp,
            proj_dim=dim, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
        ),
        family="siglip",
    )


FULL_ARCH_CONFIGS: dict[str, DualEncoderConfig] = {
    # openai/clip-vit-large-patch14-336
    "OpenAI-CLIP-L": _clip(
        img=336, v_dim=1024, v_layers=24, v_heads=16, v_mlp=4096, patch=14,
        t_dim=768, t_layers=12, t_heads=12, t_mlp=3072, proj=768, act="quick_gelu",
    ),
    # laion/CLIP-ViT-H-14-laion2B-s32B-b79K (open_clip -> gelu)
    "LAION-CLIP-H": _vit_h(224, "gelu"),
    # facebook/metaclip-h14-fullcc2.5b (OpenAI arch -> quick_gelu)
    "MetaCLIP-H14": _vit_h(224, "quick_gelu"),
    # apple/DFN5B-CLIP-ViT-H-14-378 (open_clip -> gelu)
    "Apple-DFN5B-H": _vit_h(378, "gelu"),
    # google/siglip-so400m-patch14-384
    "SigLIP-400M": _siglip(img=384, patch=14, dim=1152, layers=27, heads=16, mlp=4304),
    # google/siglip-base-patch16-224 (outside the default "all" set)
    "SigLIP-Base": _siglip(img=224, patch=16, dim=768, layers=12, heads=12, mlp=3072),
}


def full_arch_config(name: str) -> DualEncoderConfig:
    return FULL_ARCH_CONFIGS[name]


def full_colpali_config():
    """vidore/colpali-v1.3: PaliGemma-3B (SigLIP-So400m/14-448 + Gemma-2B)
    with a 128-d retrieval head."""
    from .colpali import ColPaliConfig
    from .gemma import GemmaConfig

    return ColPaliConfig(
        vision=VisionConfig(
            image_size=448, patch_size=14, dim=1152, layers=27, heads=16, mlp_dim=4304,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
            use_head=False,
        ),
        gemma=GemmaConfig(
            vocab_size=257216, dim=2048, layers=18, heads=8, kv_heads=1, head_dim=256,
            mlp_dim=16384,
        ),
        embedding_dim=128,
        image_token_id=257152,
    )


def full_jina_config():
    """jinaai/jina-clip-v1: EVA02-B/16 + JinaBERT-base."""
    from .jina import Eva02Config, JinaBertConfig, JinaClipConfig

    return JinaClipConfig(vision=Eva02Config(), text=JinaBertConfig())


def arch_tokenizer(info, cfg):
    """The offline word-hash tokenizer of an arch model: ColPali's 32-token
    prompts, Jina's registry length with its EOS id 3, and each dual
    encoder's text length with the CLIP EOS id 49407. That id is past the end
    of SigLIP's 32000-row table, where the JAX package's gather clamps it to
    the last row: so the id is ``min(49407, vocab - 1)``, the row JAX reads."""
    from .zoo import hash_tokenizer

    if info.type == "colpali":
        return hash_tokenizer(cfg.gemma.vocab_size, 32, 1)
    if info.type == "jina":
        return hash_tokenizer(cfg.text.vocab_size, info.text_max_len, 3)
    return hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, min(49407, cfg.text.vocab_size - 1))


def load_arch_model(name: str, seed: int = 0, *, device, dtype=torch.bfloat16):
    """Random-init model at the FULL published architecture (throughput is
    weight-independent). The weights are drawn on ``device``."""
    from .registry import model_info
    from .zoo import LoadedModel

    info = model_info(name)
    if info.type == "jina":
        from .jina import JinaClip

        cfg = full_jina_config()
        return LoadedModel(
            info=info, cfg=cfg, model=JinaClip(cfg, seed=seed, device=device, dtype=dtype),
            preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg), weights_provenance="arch-random",
        )
    if info.type == "colpali":
        from .colpali import ColPali

        cfg = full_colpali_config()
        suffix = np.array([2, 10, 11, 12, 13, 14], np.int32)  # a 6-token prompt suffix
        return LoadedModel(
            info=info, cfg=cfg, model=ColPali(cfg, suffix, seed=seed, device=device, dtype=dtype),
            preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg),
            multi_vector=True, weights_provenance="arch-random",
        )
    cfg = full_arch_config(name)
    return LoadedModel(
        info=info, cfg=cfg, model=DualEncoder(cfg, seed=seed, device=device, dtype=dtype),
        preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg), weights_provenance="arch-random",
    )
