"""HF checkpoint -> param tree conversion for the dual-encoder towers.

Counterpart of ``multimodal_embedding_tpu/models/convert.py``. An HF state
dict (any ``Mapping`` of torch tensors or numpy arrays) is mapped tensor by
tensor into exactly the JAX package's param tree, as numpy: the layers of a
stack along a leading ``[L, ...]`` axis. ``models/params.py:params_from_jax``
then carries the tree into the port's modules, and the cast to the run's
dtype is its ``dtype=``. Conversion is pure numpy; the configs read the HF
``config.json`` object.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .towers import DualEncoderConfig, TextConfig, VisionConfig


def _t(x) -> np.ndarray:
    """torch tensor (as f32) or array-like -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").float().numpy()
    return np.asarray(x)


def _lin(sd: Mapping, prefix: str) -> dict:
    return {"w": _t(sd[f"{prefix}.weight"]).T, "b": _t(sd[f"{prefix}.bias"])}


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _patch_w(conv_w: np.ndarray) -> np.ndarray:
    """torch conv weight [D, C, ph, pw] -> [ph*pw*C, D], ``patchify``'s order."""
    return conv_w.transpose(2, 3, 1, 0).reshape(-1, conv_w.shape[0])


def stack_layers(layers: list[dict]) -> dict:
    """Per-layer trees of one structure -> one tree of ``[L, ...]`` leaves."""
    first = layers[0]
    return {k: stack_layers([lay[k] for lay in layers]) if isinstance(v, dict)
            else np.stack([lay[k] for lay in layers]) for k, v in first.items()}


def _encoder_from_hf(sd: Mapping, prefix: str, n_layers: int) -> dict:
    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{lp}.layer_norm1"),
            "attn": {
                "q": _lin(sd, f"{lp}.self_attn.q_proj"),
                "k": _lin(sd, f"{lp}.self_attn.k_proj"),
                "v": _lin(sd, f"{lp}.self_attn.v_proj"),
                "o": _lin(sd, f"{lp}.self_attn.out_proj"),
            },
            "ln2": _ln(sd, f"{lp}.layer_norm2"),
            "mlp": {"fc1": _lin(sd, f"{lp}.mlp.fc1"), "fc2": _lin(sd, f"{lp}.mlp.fc2")},
        })
    return stack_layers(layers)


# --- CLIP family (OpenAI / LAION / MetaCLIP / DFN) ---------------------------


def clip_config_from_hf(hf_cfg: Any) -> DualEncoderConfig:
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=v.image_size, patch_size=v.patch_size, dim=v.hidden_size,
            layers=v.num_hidden_layers, heads=v.num_attention_heads, mlp_dim=v.intermediate_size,
            proj_dim=hf_cfg.projection_dim, style="clip", act=v.hidden_act, ln_eps=v.layer_norm_eps,
        ),
        text=TextConfig(
            vocab_size=t.vocab_size, max_len=t.max_position_embeddings, dim=t.hidden_size,
            layers=t.num_hidden_layers, heads=t.num_attention_heads, mlp_dim=t.intermediate_size,
            proj_dim=hf_cfg.projection_dim, style="clip", act=t.hidden_act, ln_eps=t.layer_norm_eps,
            eos_token_id=t.eos_token_id,
        ),
        family="clip",
    )


def clip_params_from_hf(sd: Mapping, cfg: DualEncoderConfig) -> dict:
    vision = {
        "patch": {"w": _patch_w(_t(sd["vision_model.embeddings.patch_embedding.weight"]))},
        "cls": _t(sd["vision_model.embeddings.class_embedding"]),
        "pos": _t(sd["vision_model.embeddings.position_embedding.weight"]),
        # "pre_layrnorm" is HF's (sic) attribute name
        "pre_ln": _ln(sd, "vision_model.pre_layrnorm"),
        "encoder": _encoder_from_hf(sd, "vision_model.encoder", cfg.vision.layers),
        "post_ln": _ln(sd, "vision_model.post_layernorm"),
        "proj": _t(sd["visual_projection.weight"]).T,
    }
    text = {
        "tok": _t(sd["text_model.embeddings.token_embedding.weight"]),
        "pos": _t(sd["text_model.embeddings.position_embedding.weight"]),
        "encoder": _encoder_from_hf(sd, "text_model.encoder", cfg.text.layers),
        "final_ln": _ln(sd, "text_model.final_layer_norm"),
        "proj": _t(sd["text_projection.weight"]).T,
    }
    return {"vision": vision, "text": text}


# --- SigLIP family -----------------------------------------------------------


def siglip_config_from_hf(hf_cfg: Any) -> DualEncoderConfig:
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=v.image_size, patch_size=v.patch_size, dim=v.hidden_size,
            layers=v.num_hidden_layers, heads=v.num_attention_heads, mlp_dim=v.intermediate_size,
            proj_dim=None, style="siglip", act=v.hidden_act, ln_eps=v.layer_norm_eps,
        ),
        text=TextConfig(
            vocab_size=t.vocab_size, max_len=t.max_position_embeddings, dim=t.hidden_size,
            layers=t.num_hidden_layers, heads=t.num_attention_heads, mlp_dim=t.intermediate_size,
            proj_dim=t.hidden_size, style="siglip", act=t.hidden_act, ln_eps=t.layer_norm_eps,
        ),
        family="siglip",
    )


def _mha_from_torch_inproj(sd: Mapping, prefix: str, dim: int) -> dict:
    """torch ``nn.MultiheadAttention``'s one ``in_proj`` [3D, D] -> q, k, v and out."""
    w = _t(sd[f"{prefix}.in_proj_weight"])
    b = _t(sd[f"{prefix}.in_proj_bias"])
    return {
        "q": {"w": w[:dim].T, "b": b[:dim]},
        "k": {"w": w[dim : 2 * dim].T, "b": b[dim : 2 * dim]},
        "v": {"w": w[2 * dim :].T, "b": b[2 * dim :]},
        "o": _lin(sd, f"{prefix}.out_proj"),
    }


def siglip_params_from_hf(sd: Mapping, cfg: DualEncoderConfig) -> dict:
    vision = {
        "patch": {
            "w": _patch_w(_t(sd["vision_model.embeddings.patch_embedding.weight"])),
            "b": _t(sd["vision_model.embeddings.patch_embedding.bias"]),
        },
        "pos": _t(sd["vision_model.embeddings.position_embedding.weight"]),
        "encoder": _encoder_from_hf(sd, "vision_model.encoder", cfg.vision.layers),
        "post_ln": _ln(sd, "vision_model.post_layernorm"),
        "head": {
            "probe": _t(sd["vision_model.head.probe"]),
            "attn": _mha_from_torch_inproj(sd, "vision_model.head.attention", cfg.vision.dim),
            "ln": _ln(sd, "vision_model.head.layernorm"),
            "mlp": {"fc1": _lin(sd, "vision_model.head.mlp.fc1"), "fc2": _lin(sd, "vision_model.head.mlp.fc2")},
        },
    }
    text = {
        "tok": _t(sd["text_model.embeddings.token_embedding.weight"]),
        "pos": _t(sd["text_model.embeddings.position_embedding.weight"]),
        "encoder": _encoder_from_hf(sd, "text_model.encoder", cfg.text.layers),
        "final_ln": _ln(sd, "text_model.final_layer_norm"),
        "head": _lin(sd, "text_model.head"),
    }
    return {"vision": vision, "text": text}
