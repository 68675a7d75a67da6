"""Seeded weights of the ``colpali-deepseek`` family (ColPali's vision side
around a DeepSeek-V3 decoder) in the HF layout, made on the device one part
at a time.

The keys and shapes are those the port's converter reads
(``models/colpali.py:colpali_deepseek_from_hf``): ColPali-v1.3's
``vlm.model.vision_tower.vision_model.*`` and
``vlm.model.multi_modal_projector.linear.*``, ``DeepseekV3Model``'s names
under ``vlm.model.language_model``, and ``embedding_proj_layer.*``. The
parts are ``"vision"``, ``"misc"`` (projector, token embedding, final norm,
head) and ``"layer.<i>"``; each comes from its own seed, drawn as
``weights.py`` draws a whole model (one ``torch.randn`` in the served dtype,
linear weights, biases, embeddings and the router's correction bias
N(0, 0.02), norm scales 1 + N(0, 0.02)), so the port's loader and the
reference can each ask for one part at a time and get the same tensors.
"""

from __future__ import annotations

import torch

from .harness import sub_seed
from .weights import LN_SCALE, WEIGHT, _encoder, _linear, _ln

VISION = "vlm.model.vision_tower.vision_model"
LM = "vlm.model.language_model"


def parts(cfg: dict) -> list[str]:
    """The parts, in the order the model runs them."""
    return ["vision", "misc"] + [f"layer.{i}" for i in range(cfg["num_hidden_layers"])]


def _layer_keys(cfg: dict, i: int) -> list:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    p = f"{LM}.layers.{i}"
    keys = [(f"{p}.input_layernorm.weight", (d,), LN_SCALE), (f"{p}.post_attention_layernorm.weight", (d,), LN_SCALE)]
    keys += _linear(f"{p}.self_attn.q_proj", d, h * (nope + rope), bias=False)
    keys += _linear(f"{p}.self_attn.kv_a_proj_with_mqa", d, rank + rope, bias=False)
    keys += [(f"{p}.self_attn.kv_a_layernorm.weight", (rank,), LN_SCALE)]
    keys += _linear(f"{p}.self_attn.kv_b_proj", rank, h * (nope + vd), bias=False)
    keys += _linear(f"{p}.self_attn.o_proj", h * vd, d, bias=False)

    def mlp(prefix, width):
        return (_linear(f"{prefix}.gate_proj", d, width, bias=False)
                + _linear(f"{prefix}.up_proj", d, width, bias=False)
                + _linear(f"{prefix}.down_proj", width, d, bias=False))

    if i < cfg["first_k_dense_replace"]:
        return keys + mlp(f"{p}.mlp", cfg["intermediate_size"])
    e, width = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    keys += [(f"{p}.mlp.gate.weight", (e, d), WEIGHT), (f"{p}.mlp.gate.e_score_correction_bias", (e,), WEIGHT)]
    for j in range(e):
        keys += mlp(f"{p}.mlp.experts.{j}", width)
    return keys + mlp(f"{p}.mlp.shared_experts", cfg["n_shared_experts"] * width)


def part_keys(cfg: dict, part: str) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of ``part``."""
    if part.startswith("layer."):
        return _layer_keys(cfg, int(part.split(".")[1]))
    vc, d = cfg["vision_config"], cfg["hidden_size"]
    dv, p = vc["hidden_size"], vc["patch_size"]
    if part == "vision":
        keys = [(f"{VISION}.embeddings.patch_embedding.weight", (dv, 3, p, p), WEIGHT),
                (f"{VISION}.embeddings.patch_embedding.bias", (dv,), WEIGHT),
                (f"{VISION}.embeddings.position_embedding.weight", ((vc["image_size"] // p) ** 2, dv), WEIGHT)]
        return keys + _encoder(VISION, vc) + _ln(f"{VISION}.post_layernorm", dv)
    if part == "misc":
        return (_linear("vlm.model.multi_modal_projector.linear", dv, d)
                + [(f"{LM}.embed_tokens.weight", (cfg["vocab_size"], d), WEIGHT), (f"{LM}.norm.weight", (d,), LN_SCALE)]
                + _linear("embedding_proj_layer", d, cfg["embedding_dim"]))
    raise KeyError(part)


def draw(cfg: dict, part: str, seed: int, *, device, dtype) -> dict[str, torch.Tensor]:
    """``part``'s HF-layout tensors from the run's weight ``seed``: views into
    one buffer of normals drawn on ``device`` in ``dtype``."""
    keys = sorted(part_keys(cfg, part), key=lambda k: k[2] == LN_SCALE)  # the norm scales last
    sizes = [torch.Size(shape).numel() for _, shape, _ in keys]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1000 + parts(cfg).index(part)))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    buf.mul_(0.02)
    n_weight = sum(s for s, k in zip(sizes, keys) if k[2] == WEIGHT)
    buf[n_weight:].add_(1.0)
    out, off = {}, 0
    for (name, shape, _), size in zip(keys, sizes):
        out[name] = buf[off : off + size].view(shape)
        off += size
    return out
