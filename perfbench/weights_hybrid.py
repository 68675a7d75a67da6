"""Seeded weights of the ``colpali-granite`` family (ColPali's vision side
around Granite-4.0-H's hybrid Mamba-2 and MoE decoder) in the HF layout, made
on the device one part at a time.

The keys and shapes are those the port's converter reads
(``models/colpali.py:colpali_granite_from_hf``): the vision side and the
``"misc"`` part (projector, token embedding, final norm, head) as
``weights_moe.py`` draws them, and ``GraniteMoeHybridModel``'s layer names
under ``vlm.model.language_model``. The parts are ``"vision"``, ``"misc"``
and ``"layer.<i>"``, each from its own seed, so the port's loader and the
reference can each ask for one part at a time and get the same tensors.

A layer's values: one ``torch.randn`` in the served dtype for its linear
weights, expert weights and router (N(0, 0.02)) and its norm gains, the
gated norm's included (1 + N(0, 0.02)); then, from one ``torch.rand`` in
f32, a Mamba-2 mixer's parameters as mamba_ssm's Mamba-2 module draws them:
``A_log = log(A)`` with A uniform on [1, 16], ``dt_bias`` the inverse
softplus of a dt log-uniform on [``time_step_min``, ``time_step_max``] =
[0.001, 0.1], and the depthwise conv's weight and bias uniform on
+-1/sqrt(``mamba_d_conv``) (``nn.Conv1d``'s default, which mamba_ssm keeps);
``D`` ones. The published ``_init_weights`` (A = 1 ... 128, ``dt_bias`` 1)
would give every head a decay of 0.27 a token or less, so that the state
would carry nothing across a chunk.
"""

from __future__ import annotations

import math

import torch

from . import weights_moe
from .harness import sub_seed
from .weights import LN_SCALE, WEIGHT, _linear

LM = weights_moe.LM
A_LOG, DT_BIAS, CONV, ONES = "a_log", "dt_bias", "conv", "ones"
DT_MIN, DT_MAX = 0.001, 0.1


def parts(cfg: dict) -> list[str]:
    """The parts, in the order the model runs them."""
    return ["vision", "misc"] + [f"layer.{i}" for i in range(cfg["num_hidden_layers"])]


def _layer_keys(cfg: dict, i: int) -> list:
    d = cfg["hidden_size"]
    p = f"{LM}.layers.{i}"
    keys = [(f"{p}.input_layernorm.weight", (d,), LN_SCALE), (f"{p}.post_attention_layernorm.weight", (d,), LN_SCALE)]
    if cfg["layer_types"][i] == "mamba":
        inner, heads, state = cfg["mamba_expand"] * d, cfg["mamba_n_heads"], cfg["mamba_d_state"]
        conv = inner + 2 * cfg["mamba_n_groups"] * state
        m = f"{p}.mamba"
        keys += _linear(f"{m}.in_proj", d, inner + conv + heads, bias=False)
        keys += [(f"{m}.conv1d.weight", (conv, 1, cfg["mamba_d_conv"]), CONV), (f"{m}.conv1d.bias", (conv,), CONV),
                 (f"{m}.dt_bias", (heads,), DT_BIAS), (f"{m}.A_log", (heads,), A_LOG), (f"{m}.D", (heads,), ONES),
                 (f"{m}.norm.weight", (inner,), LN_SCALE)]
        keys += _linear(f"{m}.out_proj", inner, d, bias=False)
    else:
        h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = d // h
        for name, width in (("q_proj", h * hd), ("k_proj", kv * hd), ("v_proj", kv * hd)):
            keys += _linear(f"{p}.self_attn.{name}", d, width, bias=False)
        keys += _linear(f"{p}.self_attn.o_proj", h * hd, d, bias=False)
    e, width, shared = cfg["num_local_experts"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    moe = f"{p}.block_sparse_moe"
    keys += [(f"{moe}.input_linear.weight", (e, 2 * width, d), WEIGHT),
             (f"{moe}.output_linear.weight", (e, d, width), WEIGHT),
             (f"{moe}.router.layer.weight", (e, d), WEIGHT)]
    keys += _linear(f"{p}.shared_mlp.input_linear", d, 2 * shared, bias=False)
    return keys + _linear(f"{p}.shared_mlp.output_linear", shared, d, bias=False)


def part_keys(cfg: dict, part: str) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of ``part``."""
    if part.startswith("layer."):
        return _layer_keys(cfg, int(part.split(".")[1]))
    return weights_moe.part_keys(cfg, part)


def _uniform(kind: str, u: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A Mamba-2 parameter of ``kind`` from uniforms ``u`` on [0, 1), in f32."""
    if kind == A_LOG:
        return torch.log(1.0 + 15.0 * u)
    if kind == DT_BIAS:
        dt = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX) - math.log(DT_MIN)))
        return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt
    if kind == CONV:
        return (2.0 * u - 1.0) / math.sqrt(cfg["mamba_d_conv"])
    return torch.ones_like(u)


def draw(cfg: dict, part: str, seed: int, *, device, dtype) -> dict[str, torch.Tensor]:
    """``part``'s HF-layout tensors from the run's weight ``seed``: views into
    one buffer of normals drawn on ``device`` in ``dtype``, and the Mamba-2
    parameters from uniforms drawn in f32."""
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
            out[name] = _uniform(kind, u, cfg).to(dtype)
    return out
