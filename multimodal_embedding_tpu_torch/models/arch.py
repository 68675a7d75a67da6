"""Full-scale architecture configs, for runs without checkpoint weights.

Counterpart of ``multimodal_embedding_tpu/models/arch.py``: the architecture,
and so the performance envelope, of the HF checkpoint the reference loads;
only the weights are random. This slice of the port carries the dense
flagship, OpenAI-CLIP-L.
"""

from __future__ import annotations

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


FULL_ARCH_CONFIGS: dict[str, DualEncoderConfig] = {
    # openai/clip-vit-large-patch14-336
    "OpenAI-CLIP-L": _clip(
        img=336, v_dim=1024, v_layers=24, v_heads=16, v_mlp=4096, patch=14,
        t_dim=768, t_layers=12, t_heads=12, t_mlp=3072, proj=768, act="quick_gelu",
    ),
}


def full_arch_config(name: str) -> DualEncoderConfig:
    if name not in FULL_ARCH_CONFIGS:
        raise NotImplementedError(f"the full architecture of {name} is not yet ported")
    return FULL_ARCH_CONFIGS[name]


def load_arch_model(name: str, seed: int = 0, *, device, dtype=torch.bfloat16):
    """Random-init model at the FULL published architecture (throughput is
    weight-independent)."""
    from .registry import model_info
    from .zoo import LoadedModel, hash_tokenizer

    info = model_info(name)
    cfg = full_arch_config(name)
    return LoadedModel(
        info=info, cfg=cfg, model=DualEncoder(cfg, seed=seed, device=device, dtype=dtype),
        preprocess=info.preprocess,
        tokenize=hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, 49407),
        weights_provenance="arch-random",
    )
