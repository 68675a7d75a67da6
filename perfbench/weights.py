"""Seeded weights in the HF checkpoint layout, made on the device.

The keys and shapes are those of the published ``CLIPModel`` and
``SiglipModel`` state dicts that the port's converters read
(``models/convert.py``), worked out from the configuration file. All values
come from one ``torch.randn`` call in the dtype the model is served in, on
the device, then one scaling a kind over contiguous slices: linear weights,
embeddings and biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02),
LayerNorm shifts N(0, 0.02). No value is zero, so a weight read from the
wrong place or the wrong way round changes the output. The port and the
reference both read these tensors; neither sees the other's copy.
"""

from __future__ import annotations

import torch

WEIGHT, LN_SCALE = "weight", "ln_scale"


def _linear(prefix: str, d_in: int, d_out: int, bias: bool = True) -> list:
    out = [(f"{prefix}.weight", (d_out, d_in), WEIGHT)]
    return out + ([(f"{prefix}.bias", (d_out,), WEIGHT)] if bias else [])


def _ln(prefix: str, d: int) -> list:
    return [(f"{prefix}.weight", (d,), LN_SCALE), (f"{prefix}.bias", (d,), WEIGHT)]


def _encoder(prefix: str, c: dict) -> list:
    d, mlp = c["hidden_size"], c["intermediate_size"]
    keys = []
    for i in range(c["num_hidden_layers"]):
        p = f"{prefix}.encoder.layers.{i}"
        keys += _ln(f"{p}.layer_norm1", d)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys += _linear(f"{p}.self_attn.{name}", d, d)
        keys += _ln(f"{p}.layer_norm2", d)
        keys += _linear(f"{p}.mlp.fc1", d, mlp) + _linear(f"{p}.mlp.fc2", mlp, d)
    return keys


def hf_keys(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor the port's converter reads."""
    vc, tc = cfg["vision_config"], cfg["text_config"]
    dv, dt, p = vc["hidden_size"], tc["hidden_size"], vc["patch_size"]
    patches = (vc["image_size"] // p) ** 2
    keys = []
    if cfg["family"] == "clip":
        e = cfg["projection_dim"]
        keys += [("vision_model.embeddings.class_embedding", (dv,), WEIGHT),
                 ("vision_model.embeddings.patch_embedding.weight", (dv, 3, p, p), WEIGHT),
                 ("vision_model.embeddings.position_embedding.weight", (patches + 1, dv), WEIGHT)]
        keys += _ln("vision_model.pre_layrnorm", dv)
        keys += _encoder("vision_model", vc) + _ln("vision_model.post_layernorm", dv)
        keys += [("visual_projection.weight", (e, dv), WEIGHT)]
        keys += [("text_model.embeddings.token_embedding.weight", (tc["vocab_size"], dt), WEIGHT),
                 ("text_model.embeddings.position_embedding.weight", (tc["max_position_embeddings"], dt), WEIGHT)]
        keys += _encoder("text_model", tc) + _ln("text_model.final_layer_norm", dt)
        keys += [("text_projection.weight", (e, dt), WEIGHT)]
        return keys
    keys += [("vision_model.embeddings.patch_embedding.weight", (dv, 3, p, p), WEIGHT),
             ("vision_model.embeddings.patch_embedding.bias", (dv,), WEIGHT),
             ("vision_model.embeddings.position_embedding.weight", (patches, dv), WEIGHT)]
    keys += _encoder("vision_model", vc) + _ln("vision_model.post_layernorm", dv)
    keys += [("vision_model.head.probe", (1, 1, dv), WEIGHT),
             ("vision_model.head.attention.in_proj_weight", (3 * dv, dv), WEIGHT),
             ("vision_model.head.attention.in_proj_bias", (3 * dv,), WEIGHT)]
    keys += _linear("vision_model.head.attention.out_proj", dv, dv) + _ln("vision_model.head.layernorm", dv)
    keys += _linear("vision_model.head.mlp.fc1", dv, vc["intermediate_size"])
    keys += _linear("vision_model.head.mlp.fc2", vc["intermediate_size"], dv)
    keys += [("text_model.embeddings.token_embedding.weight", (tc["vocab_size"], dt), WEIGHT),
             ("text_model.embeddings.position_embedding.weight", (tc["max_position_embeddings"], dt), WEIGHT)]
    keys += _encoder("text_model", tc) + _ln("text_model.final_layer_norm", dt)
    keys += _linear("text_model.head", dt, dt)
    return keys


def make_state_dict(cfg: dict, seed: int, *, device, dtype) -> dict[str, torch.Tensor]:
    """The HF-layout state dict of ``cfg`` from ``seed``: views into one
    buffer of normals drawn on ``device`` in ``dtype``."""
    keys = sorted(hf_keys(cfg), key=lambda k: k[2] == LN_SCALE)  # the LayerNorm scales last
    sizes = [torch.Size(shape).numel() for _, shape, _ in keys]
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    buf.mul_(0.02)
    n_weight = sum(s for s, k in zip(sizes, keys) if k[2] == WEIGHT)
    buf[n_weight:].add_(1.0)
    out, off = {}, 0
    for (name, shape, _), size in zip(keys, sizes):
        out[name] = buf[off : off + size].view(shape)
        off += size
    return out
