"""Seeded weights of the ``colpali-kimi-linear`` family (ColPali's vision
side around Kimi-Linear's hybrid KDA and MLA decoder with its MoE) in the HF
layout, made on the device one part at a time.

The keys and shapes are those the port's converter reads
(``models/colpali.py:colpali_kimi_linear_from_hf``,
``models/kimi_linear.py:layer_from_hf``): the vision side and the ``"misc"``
part (projector, token embedding, final norm, head) as ``weights_moe.py``
draws them, and ``KimiDecoderLayer``'s names under
``vlm.model.language_model``. The parts are ``"vision"``, ``"misc"`` and
``"layer.<i>"``, each from its own seed, so the port's loader and the
reference can each ask for one part at a time and get the same tensors.

A layer's values: one ``torch.randn`` in the served dtype for its linear
weights, expert weights, router and correction bias (N(0, 0.02)) and its norm
gains, the KDA output norm's included (1 + N(0, 0.02)); then, from one
``torch.rand`` in f32, a KDA mixer's parameters: ``A_log = log(A)`` with A
uniform on [1, 16] a head (the published module's initialiser), ``dt_bias``
the inverse softplus of a dt log-uniform on [0.001, 0.1] a channel (as
``weights_hybrid.py`` draws Mamba-2's), both kept in f32 as the published
module declares them, and the three short convs' weights uniform on
+-1/sqrt(width) (``nn.Conv1d``'s default; the convs have no bias) in the served
dtype. With these, a token's decay a channel is exp(-A dt) with A dt in about
[0.001, 1.6], so the state carries over hundreds of tokens in some channels
and a few in others.
"""

from __future__ import annotations

import math

import torch

from . import weights_moe
from .harness import sub_seed
from .weights import LN_SCALE, WEIGHT, _linear

LM = weights_moe.LM
A_LOG, DT_BIAS, CONV = "a_log", "dt_bias", "conv"
DT_MIN, DT_MAX = 0.001, 0.1
F32_KINDS = (A_LOG, DT_BIAS)


def parts(cfg: dict) -> list[str]:
    """The parts, in the order the model runs them."""
    return ["vision", "misc"] + [f"layer.{i}" for i in range(cfg["num_hidden_layers"])]


def is_kda(cfg: dict, i: int) -> bool:
    """Whether layer ``i`` (0-based) is a KDA layer (``kda_layers`` is 1-based)."""
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def _mlp(prefix: str, d: int, width: int) -> list:
    return (_linear(f"{prefix}.gate_proj", d, width, bias=False) + _linear(f"{prefix}.up_proj", d, width, bias=False)
            + _linear(f"{prefix}.down_proj", width, d, bias=False))


def _layer_keys(cfg: dict, i: int) -> list:
    d = cfg["hidden_size"]
    p = f"{LM}.layers.{i}"
    a = f"{p}.self_attn"
    keys = [(f"{p}.input_layernorm.weight", (d,), LN_SCALE), (f"{p}.post_attention_layernorm.weight", (d,), LN_SCALE)]
    if is_kda(cfg, i):
        lin = cfg["linear_attn_config"]
        h, hd, width = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
        n = h * hd
        for name in "qkv":
            keys += _linear(f"{a}.{name}_proj", d, n, bias=False)
            keys += [(f"{a}.{name}_conv1d.weight", (n, 1, width), CONV)]
        keys += _linear(f"{a}.f_a_proj", d, hd, bias=False) + _linear(f"{a}.f_b_proj", hd, n, bias=False)
        keys += _linear(f"{a}.g_a_proj", d, hd, bias=False) + _linear(f"{a}.g_b_proj", hd, n, bias=False)
        keys += _linear(f"{a}.b_proj", d, h, bias=False)
        keys += [(f"{a}.A_log", (h,), A_LOG), (f"{a}.dt_bias", (n,), DT_BIAS), (f"{a}.o_norm.weight", (hd,), LN_SCALE)]
        keys += _linear(f"{a}.o_proj", n, d, bias=False)
    else:
        h, nope, rope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
        keys += _linear(f"{a}.q_proj", d, h * (nope + rope), bias=False)
        keys += _linear(f"{a}.kv_a_proj_with_mqa", d, rank + rope, bias=False)
        keys += [(f"{a}.kv_a_layernorm.weight", (rank,), LN_SCALE)]
        keys += _linear(f"{a}.kv_b_proj", rank, h * (nope + vd), bias=False)
        keys += _linear(f"{a}.o_proj", h * vd, d, bias=False)
    if i < cfg["first_k_dense_replace"]:
        return keys + _mlp(f"{p}.mlp", d, cfg["intermediate_size"])
    e, width, moe = cfg["num_experts"], cfg["moe_intermediate_size"], f"{p}.block_sparse_moe"
    keys += [(f"{moe}.gate.weight", (e, d), WEIGHT), (f"{moe}.gate.e_score_correction_bias", (e,), WEIGHT)]
    for j in range(e):
        keys += (_linear(f"{moe}.experts.{j}.w1", d, width, bias=False)
                 + _linear(f"{moe}.experts.{j}.w2", width, d, bias=False)
                 + _linear(f"{moe}.experts.{j}.w3", d, width, bias=False))
    return keys + _mlp(f"{moe}.shared_experts", d, cfg["num_shared_experts"] * width)


def part_keys(cfg: dict, part: str) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of ``part``."""
    if part.startswith("layer."):
        return _layer_keys(cfg, int(part.split(".")[1]))
    return weights_moe.part_keys(cfg, part)


def _uniform(kind: str, u: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A KDA parameter of ``kind`` from uniforms ``u`` on [0, 1), in f32."""
    if kind == A_LOG:
        return torch.log(1.0 + 15.0 * u)
    if kind == DT_BIAS:
        dt = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX) - math.log(DT_MIN)))
        return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt
    return (2.0 * u - 1.0) / math.sqrt(cfg["linear_attn_config"]["short_conv_kernel_size"])


def draw(cfg: dict, part: str, seed: int, *, device, dtype) -> dict[str, torch.Tensor]:
    """``part``'s HF-layout tensors from the run's weight ``seed``: views into
    one buffer of normals drawn on ``device`` in ``dtype``, and the KDA
    parameters from uniforms drawn in f32 (``A_log`` and ``dt_bias`` kept in
    f32, the convs in ``dtype``)."""
    keys = part_keys(cfg, part)
    normal = sorted((k for k in keys if k[2] in (WEIGHT, LN_SCALE)), key=lambda k: k[2] == LN_SCALE)
    other = [k for k in keys if k[2] not in (WEIGHT, LN_SCALE)]
    index = parts(cfg).index(part)
    sizes = [torch.Size(shape).numel() for _, shape, _ in normal]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1000 + index))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    buf.mul_(0.02)
    n_weight = sum(s for s, k in zip(sizes, normal) if k[2] == WEIGHT)
    buf[n_weight:].add_(1.0)
    out, off = {}, 0
    for (name, shape, _), size in zip(normal, sizes):
        out[name] = buf[off : off + size].view(shape)
        off += size
    if other:
        gen.manual_seed(sub_seed(seed, 5000 + index))
        for name, shape, kind in other:
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = _uniform(kind, u, cfg).to(torch.float32 if kind in F32_KINDS else dtype)
    return out
