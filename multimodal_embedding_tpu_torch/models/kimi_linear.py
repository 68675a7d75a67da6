"""Kimi-Linear's hybrid decoder: Kimi Delta Attention (KDA) layers and MLA
layers without rope, three to one, each followed by a mixture-of-experts MLP
with a shared expert (the first layer a dense MLP); ColPali (``colpali.py``)
runs it in place of Gemma.

The equations are those of the published ``modeling_kimi.py``
(``KimiLinearForCausalLM``, ``model_type`` "kimi_linear"):

- RMSNorm with f32 statistics; each layer ``h = h + mixer(rmsnorm(h))``, then
  ``h = h + mlp(rmsnorm(h))``; a final RMSNorm; no scale on the token
  embeddings; no LM head is held (ColPali reads the final hidden states);
- the MLA layers (``linear_attn_config.full_attn_layers``) and every MLP are
  ``deepseek.py``'s :class:`~.deepseek.DeepseekLayer`, with ``nope``
  (``mla_use_nope``): the 64-wide rope parts of q and of the shared key kept
  as they are, unrotated. The MoE is ``ops/moe.py:moe``: sigmoid scores, the
  correction bias for the choice, the top ``num_experts_per_token`` of
  ``num_experts``, the chosen scores renormalised (``moe_renormalize``) and
  times ``routed_scaling_factor``, plus ``num_shared_experts`` shared
  experts;
- the KDA layers (``linear_attn_config.kda_layers``): q, k and v
  projections, each through a causal depthwise conv of width
  ``short_conv_kernel_size`` without bias, then SiLU; the log decays ``g =
  -exp(A_log_h) * softplus(f_b(f_a(x)) + dt_bias)`` in f32, one a key
  channel; ``beta = sigmoid(b(x))`` in f32, one a head; the recurrence of
  ``ops/kda.py`` (q and k L2-normalised in it, scale ``head_dim^-1/2``, each
  head's state [128, 128] in f32: the kernel on the card); the gated norm
  ``w * rmsnorm(o) * sigmoid(g_b(g_a(x)))`` over each head's channels in f32
  at ``rms_norm_eps``; ``o_proj``.

Departures from the published code, each where a value is rounded or a mask
falls:

- RMSNorm rounds ``w * x_normed`` once to the hidden dtype (the published
  norm rounds the normed value, then multiplies by the gain in that dtype);
- the routed and shared experts' outputs are summed in the combine's kernel
  with f32 weights (``ops/moe.py``), as for Kimi-VL;
- the published layer drops the padded positions of a masked batch and runs
  the rest as one packed sequence (``cu_seqlens``); here a key mask zeroes the
  padded positions of the mixer's input, of the convs' outputs (so q, k and v
  are zero there) and of g (so the state passes a pad unchanged), which
  gives the valid positions the same outputs.

Weights: dense projections ``[d_in, d_out]`` (the port's layout). A KDA
layer's ``kda.qkv`` [D, 3 n] stacks q, k and v (n = heads x head_dim) and
``kda.conv`` [3 n, 1, width] their three convs, so that one product and one
conv serve all three; ``kda.gates_a`` [D, 2 head_dim + heads] stacks
``f_a_proj``, ``g_a_proj`` and ``b_proj``, which all read the normed input;
``kda.f_b`` and ``kda.g_b`` [head_dim, n]; ``kda.A_log`` [heads] and
``kda.dt_bias`` [n] in f32; ``kda.o_norm`` [head_dim]; ``kda.o`` [n, D].
:func:`layer_from_hf` converts an HF ``KimiDecoderLayer`` on the tensors'
own device.

The model keeps a :class:`~..utils.profiling.Tally` (``tally``): the MoE's
spans and ``moe.routed_rows`` as ``deepseek.py`` keeps them, and the KDA
layers' spans ``kda.in`` (the projections, the convs, g and beta),
``kda.scan`` and ``kda.out`` (the gated norm and ``o_proj``) and count
``kda.tokens`` (batch rows times length, a KDA layer). Expert loads and the
route sink are ``decoder.RoutedLM``'s, one row a MoE layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kda import kda
from .decoder import owned
from .deepseek import DeepseekConfig, DeepseekLayer, DeepseekLM, mla_from_hf


@dataclass(frozen=True)
class KimiLinearConfig(DeepseekConfig):
    """A ``DeepseekConfig`` (its MLA, dense MLP and MoE) with the KDA layers:
    ``kda_layers`` the 0-based indices of the layers whose mixer is KDA, of
    ``kda_heads`` heads of ``kda_head_dim``."""

    nope: bool = True
    kda_layers: tuple[int, ...] = ()
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_width: int = 4

    @property
    def kda_dim(self) -> int:
        return self.kda_heads * self.kda_head_dim


_HF_KEYS = {"vocab_size": "vocab_size", "dim": "hidden_size", "layers": "num_hidden_layers",
            "heads": "num_attention_heads", "mlp_dim": "intermediate_size", "moe_dim": "moe_intermediate_size",
            "n_experts": "num_experts", "top_k": "num_experts_per_token", "n_shared": "num_shared_experts",
            "first_dense": "first_k_dense_replace", "kv_rank": "kv_lora_rank", "qk_nope_dim": "qk_nope_head_dim",
            "qk_rope_dim": "qk_rope_head_dim", "v_dim": "v_head_dim", "routed_scale": "routed_scaling_factor",
            "norm_topk": "moe_renormalize", "rope_theta": "rope_theta", "rms_eps": "rms_norm_eps",
            "nope": "mla_use_nope"}


def kimi_linear_config_from_hf(c) -> KimiLinearConfig:
    """A ``KimiLinearConfig`` from a Kimi-Linear ``config.json`` (or any object
    or mapping with its keys; ``linear_attn_config``'s layers 1-based, as
    published). Raises on what this module does not run: a query LoRA, grouped
    routing, scores other than sigmoid, rope scaling, an activation other than
    silu, a layer that is neither KDA nor MLA."""
    get = c.get if isinstance(c, Mapping) else lambda k, d=None: getattr(c, k, d)
    want = {"q_lora_rank": None, "rope_scaling": None, "moe_router_activation_func": "sigmoid",
            "num_expert_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu"}
    for key, value in want.items():
        if get(key, value) != value:
            raise ValueError(f"Kimi-Linear decoder: {key}={get(key)!r} is not supported (only {value!r})")
    lin = get("linear_attn_config")
    n = get("num_hidden_layers")
    kda_layers, full = sorted(lin["kda_layers"]), sorted(lin["full_attn_layers"])
    if sorted(kda_layers + full) != list(range(1, n + 1)):
        raise ValueError(f"Kimi-Linear decoder: kda_layers {kda_layers} and full_attn_layers {full} must split "
                         f"layers 1..{n}")
    return KimiLinearConfig(**{k: get(hf) for k, hf in _HF_KEYS.items()}, kda_layers=tuple(i - 1 for i in kda_layers),
                            kda_heads=lin["num_heads"], kda_head_dim=lin["head_dim"],
                            conv_width=lin["short_conv_kernel_size"])


def gated_head_norm(o: torch.Tensor, gate: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``w * rmsnorm(o) * sigmoid(gate)`` over the last axis (a head's
    channels), in f32, rounded once to gate's dtype (``FusedRMSNormGated``
    with ``activation="sigmoid"``)."""
    of = o.float()
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps)
    return (w.float() * y * torch.sigmoid(gate.float())).to(gate.dtype)


class KimiLinearLayer(DeepseekLayer):
    """A :class:`~.deepseek.DeepseekLayer` whose mixer, where the layer is a
    KDA layer, is ``kda.{qkv,conv,gates_a,f_b,g_b,A_log,dt_bias,o_norm,o}``
    in place of ``attn``."""

    def make_mixer(self, p) -> None:
        cfg = self.cfg
        self.kind = "kda" if self.index in cfg.kda_layers else "mla"
        if self.kind == "mla":
            super().make_mixer(p)
            return
        d, n, hd, h = cfg.dim, cfg.kda_dim, cfg.kda_head_dim, cfg.kda_heads
        self.kda = nn.ParameterDict({
            "qkv": p(d, 3 * n), "conv": p(3 * n, 1, cfg.conv_width), "gates_a": p(d, 2 * hd + h),
            "f_b": p(hd, n), "g_b": p(hd, n), "A_log": p(h, dtype=torch.float32), "dt_bias": p(n, dtype=torch.float32),
            "o_norm": p(hd, std=None), "o": p(n, d),
        })

    def kda_mix(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        """The KDA mixer over the normed x [B, T, D] -> [B, T, D]."""
        cfg, p, tally = self.cfg, self.kda, self.tally
        b, t, _ = x.shape
        n, hd, h = cfg.kda_dim, cfg.kda_head_dim, cfg.kda_heads
        mask = None if key_mask is None else key_mask[:, :, None].to(x.dtype)
        with tally.span("kda.in"):
            if mask is not None:
                x = x * mask
            qkv = F.conv1d((x @ p["qkv"]).transpose(1, 2), p["conv"], padding=cfg.conv_width - 1, groups=3 * n)
            qkv = F.silu(qkv[..., :t].transpose(1, 2).contiguous(), inplace=True)  # [B, T, 3n]
            if mask is not None:
                qkv = qkv * mask
            q, k, v = (u.unflatten(-1, (h, hd)) for u in qkv.split(n, dim=-1))
            fa, ga, bl = (x @ p["gates_a"]).split([hd, hd, h], dim=-1)
            g = -torch.exp(p["A_log"].float())[:, None] * F.softplus(
                (fa @ p["f_b"]).float().unflatten(-1, (h, hd)) + p["dt_bias"].float().view(h, hd))
            if mask is not None:
                g = g * key_mask[:, :, None, None]
            beta = torch.sigmoid(bl.float())
        with tally.span("kda.scan"):
            o = kda(q, k, v, g, beta)
        tally.count("kda.tokens", b * t)
        with tally.span("kda.out"):
            gate = (ga @ p["g_b"]).unflatten(-1, (h, hd))
            return gated_head_norm(o, gate, p["o_norm"], cfg.rms_eps).flatten(2) @ p["o"]

    def mix(self, x, positions, key_mask, causal: bool) -> torch.Tensor:
        """KDA (always causal) or the MLA of :class:`~.deepseek.DeepseekLayer`."""
        if self.kind == "mla":
            return super().mix(x, positions, key_mask, causal)
        if not causal:
            raise NotImplementedError("a KDA layer is causal")
        return self.kda_mix(x, key_mask)


class KimiLinearLM(DeepseekLM):
    """Token embedding table ``embed`` [V, D], ``layers.<i>``
    (:class:`KimiLinearLayer`), ``final_norm``."""

    layer_cls = KimiLinearLayer


def layer_from_hf(sd: Mapping[str, torch.Tensor], prefix: str, cfg: KimiLinearConfig, index: int,
                  dtype) -> dict[str, torch.Tensor]:
    """HF ``KimiDecoderLayer`` ``prefix.layers.<index>`` tensors -> this
    module's ``layers.<index>.*`` names, on their own device in ``dtype`` (the
    router and its bias, ``A_log`` and ``dt_bias`` in f32). The HF names: the
    norms ``input_layernorm`` and ``post_attention_layernorm``; ``self_attn``
    the MLA (``deepseek.mla_from_hf``) or the KDA (``{q,k,v}_proj``,
    ``{q,k,v}_conv1d.weight`` [n, 1, width], ``A_log`` [heads], ``dt_bias``
    [n], ``f_a_proj``, ``f_b_proj``, ``b_proj``, ``g_a_proj``, ``g_b_proj``,
    ``o_norm.weight``, ``o_proj``); ``mlp.{gate,up,down}_proj`` in a dense
    layer; ``block_sparse_moe.gate.weight``, ``.gate.e_score_correction_bias``,
    ``.experts.<e>.w1`` (gate), ``.w2`` (down), ``.w3`` (up) and
    ``.shared_experts.{gate,up,down}_proj`` in a MoE layer."""
    lp = f"{prefix}.layers.{index}"

    def w(key, t=True):
        x = sd[f"{lp}.{key}"]
        return owned(x.T if t else x, dtype)

    out = {"ln1": w("input_layernorm.weight", False), "ln2": w("post_attention_layernorm.weight", False)}
    if index in cfg.kda_layers:
        a = f"{lp}.self_attn"
        out.update({
            "kda.qkv": torch.cat([w(f"self_attn.{n}_proj.weight") for n in "qkv"], dim=1),
            "kda.conv": torch.cat([w(f"self_attn.{n}_conv1d.weight", False) for n in "qkv"]),
            "kda.gates_a": torch.cat([w(f"self_attn.{n}_proj.weight") for n in ("f_a", "g_a", "b")], dim=1),
            "kda.f_b": w("self_attn.f_b_proj.weight"), "kda.g_b": w("self_attn.g_b_proj.weight"),
            "kda.A_log": owned(sd[f"{a}.A_log"].reshape(-1), torch.float32),
            "kda.dt_bias": owned(sd[f"{a}.dt_bias"].reshape(-1), torch.float32),
            "kda.o_norm": w("self_attn.o_norm.weight", False), "kda.o": w("self_attn.o_proj.weight"),
        })
    else:
        out.update(mla_from_hf(w))
    if index < cfg.first_dense:
        out["mlp.gate_up"] = torch.cat([w("mlp.gate_proj.weight"), w("mlp.up_proj.weight")], dim=1)
        out["mlp.down"] = w("mlp.down_proj.weight")
    else:
        moe = f"{lp}.block_sparse_moe"
        out["mlp.router"] = owned(sd[f"{moe}.gate.weight"], torch.float32)
        out["mlp.bias"] = owned(sd[f"{moe}.gate.e_score_correction_bias"], torch.float32)
        ex = f"{moe}.experts"
        out["mlp.w13"] = torch.stack([torch.cat([sd[f"{ex}.{e}.w1.weight"], sd[f"{ex}.{e}.w3.weight"]])
                                      for e in range(cfg.n_experts)]).to(dtype)
        out["mlp.w2"] = torch.stack([sd[f"{ex}.{e}.w2.weight"] for e in range(cfg.n_experts)]).to(dtype)
        out["mlp.shared_gate_up"] = torch.cat([w("block_sparse_moe.shared_experts.gate_proj.weight"),
                                               w("block_sparse_moe.shared_experts.up_proj.weight")], dim=1)
        out["mlp.shared_down"] = w("block_sparse_moe.shared_experts.down_proj.weight")
    return {f"layers.{index}.{k}": v for k, v in out.items()}
