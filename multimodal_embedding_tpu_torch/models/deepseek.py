"""DeepSeek-V3's decoder: multi-head latent attention (MLA) and a
mixture-of-experts MLP with shared experts, as Kimi-VL-A3B's language model
publishes it; ColPali (``colpali.py``) runs it in place of Gemma.

The equations are those of ``transformers``' ``DeepseekV3Model``:

- RMSNorm with f32 statistics and a plain ``weight * x`` gain;
- MLA without a query LoRA: q = ``x @ q`` split per head into ``qk_nope``
  and ``qk_rope`` parts; a latent ``x @ kv_a`` of ``kv_rank`` plus one
  ``qk_rope``-wide key shared by every head, the latent RMS-normed
  (``kv_norm``, at eps 1e-6 whatever ``rms_norm_eps`` says: the published
  code builds that norm with its default) and up-projected (``kv_b``) to each head's ``qk_nope`` key
  and ``v_dim`` value; the rope parts rotated with the interleaved layout
  (pairs de-interleaved, then rotate-half; here each pair turned as one
  complex number, the rotations made once a forward) at positions
  ``cumsum(mask) - 1`` in f32 (where ``nope``, ``mla_use_nope`` of a
  Kimi-Linear config, the rope parts are kept as they are, unrotated); scale
  ``(qk_nope + qk_rope)^-1/2``. Attention goes to
  ``decoder_attn.grouped_attention`` (the fused kernel on the card) at
  head size ``qk_nope + qk_rope``, the values zero-padded to it and the
  output sliced back to ``v_dim``;
- the first ``first_dense`` layers a SwiGLU MLP of ``mlp_dim``; every later
  layer the routed experts (``ops/moe.py``: sigmoid routing with a
  correction bias for the choice, ``top_k`` of ``n_experts``, normalized
  weights times ``routed_scale``) plus ``n_shared`` shared experts, one
  SwiGLU MLP of ``n_shared * moe_dim``; every SwiGLU activation (the dense
  layers', the routed and the shared experts') is ``ops/moe.py:swiglu``, one
  kernel on the card, and the routed sum and the shared output are added in
  the combine's kernel;
- no scale on the token embeddings; no LM head is held (ColPali reads the
  final hidden states).

Weights: dense projections ``[d_in, d_out]`` (the port's layout), gate and
up stacked as one ``gate_up`` ``[d, 2F]``; the router ``[E, D]`` and its
bias in f32; the experts in the checkpoint's layout, ``w13`` ``[E, 2I, D]``
(gate then up) and ``w2`` ``[E, D, I]``. :func:`layer_from_hf` converts an
HF ``DeepseekV3`` layer on the tensors' own device.

Each model keeps a :class:`~..utils.profiling.Tally` (``tally``: the MoE's
spans and ``moe.routed_rows``) and, on the device, each expert's routed rows
a MoE layer (``expert_loads``, read and cleared by
:meth:`RoutedLM.take_expert_loads`). Where ``route_sink`` is a list, each
forward appends a list of its MoE layers' chosen experts, ``[B*T, top_k]``
a layer (the tensors the router made; nothing is copied).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import moe
from ..utils.profiling import Tally
from .decoder import DecoderLayer, RoutedLM, owned, param, rms_norm, swiglu_mlp
from .decoder_attn import grouped_attention


@dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int
    dim: int
    layers: int
    heads: int
    mlp_dim: int  # the dense layers' width (``intermediate_size``)
    moe_dim: int  # one expert's width (``moe_intermediate_size``)
    n_experts: int
    top_k: int
    n_shared: int
    first_dense: int = 1
    kv_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    routed_scale: float = 2.446
    norm_topk: bool = True
    rope_theta: float = 800000.0
    rms_eps: float = 1e-5
    nope: bool = False  # ``mla_use_nope``: the rope parts of q and k left unrotated

    @property
    def head_dim(self) -> int:
        """The query and key head size."""
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def moe_layers(self) -> int:
        return self.layers - self.first_dense


_HF_KEYS = {"vocab_size": "vocab_size", "dim": "hidden_size", "layers": "num_hidden_layers",
            "heads": "num_attention_heads", "mlp_dim": "intermediate_size", "moe_dim": "moe_intermediate_size",
            "n_experts": "n_routed_experts", "top_k": "num_experts_per_tok", "n_shared": "n_shared_experts",
            "first_dense": "first_k_dense_replace", "kv_rank": "kv_lora_rank", "qk_nope_dim": "qk_nope_head_dim",
            "qk_rope_dim": "qk_rope_head_dim", "v_dim": "v_head_dim", "routed_scale": "routed_scaling_factor",
            "norm_topk": "norm_topk_prob", "rope_theta": "rope_theta", "rms_eps": "rms_norm_eps"}


def deepseek_config_from_hf(c) -> DeepseekConfig:
    """A ``DeepseekConfig`` from an HF ``DeepseekV3Config`` (or any object
    or mapping with its keys). Raises on what this module does not run: a
    query LoRA, grouped routing, rope scaling, a score function other than
    sigmoid, biased projections."""
    get = c.get if isinstance(c, Mapping) else lambda k, d=None: getattr(c, k, d)
    unsupported = {"q_lora_rank": None, "rope_scaling": None, "attention_bias": False}
    for key, want in unsupported.items():
        if get(key, want) != want:
            raise ValueError(f"DeepSeek decoder: {key}={get(key)!r} is not supported (only {want!r})")
    if get("n_group", 1) != 1 or get("topk_group", 1) != 1 or get("scoring_func", "sigmoid") != "sigmoid":
        raise ValueError("DeepSeek decoder: only one expert group and sigmoid scores are supported")
    if get("moe_layer_freq", 1) != 1 or get("hidden_act", "silu") != "silu":
        raise ValueError("DeepSeek decoder: only a MoE layer every layer after the dense ones, with silu")
    return DeepseekConfig(**{k: get(hf) for k, hf in _HF_KEYS.items()}, nope=bool(get("mla_use_nope", False)))


KV_NORM_EPS = 1e-6  # the latent's RMSNorm (``kv_a_layernorm``) takes DeepseekV3RMSNorm's default


def rope_rotation(positions: torch.Tensor, d: int, theta: float) -> torch.Tensor:
    """complex64 [B, T, 1, d / 2]: each position's rotation of the rope's
    frequency pairs, ``exp(i * position / theta ** (2j / d))``, in f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=positions.device, dtype=torch.int64).float() / d))
    ang = positions[:, :, None].float() * inv_freq
    return torch.polar(torch.ones_like(ang), ang)[:, :, None, :]


def rope_interleaved(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, d] rotated by ``rot`` (:func:`rope_rotation`) as
    ``apply_rotary_pos_emb_interleave`` rotates it: each (even, odd) pair
    turned as one complex number in f32, and the result laid out
    de-interleaved (the pairs' first parts, then their second), in x's dtype."""
    z = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    out = x.new_empty(x.shape)
    out.view(*x.shape[:-1], 2, x.shape[-1] // 2).copy_(torch.view_as_real(z * rot).transpose(-1, -2))
    return out


class DeepseekLayer(DecoderLayer):
    """``ln1``, ``attn.{q,kv_a,kv_norm,kv_b,o}``, ``ln2`` and ``mlp``: a
    dense layer's ``{gate_up,down}``, a MoE layer's ``{router,bias,w13,w2,
    shared_gate_up,shared_down}``."""

    norm = staticmethod(rms_norm)

    def __init__(self, cfg: DeepseekConfig, index: int, *, gen, device, dtype):
        super().__init__()
        self.cfg, self.index = cfg, index
        d = cfg.dim

        def p(*shape, **kw):
            return param(shape, gen, device, kw.pop("dtype", dtype), **kw)

        self.ln1, self.ln2 = p(d, std=None), p(d, std=None)
        self.make_mixer(p)
        self.is_moe = index >= cfg.first_dense
        if not self.is_moe:
            self.mlp = nn.ParameterDict({"gate_up": p(d, 2 * cfg.mlp_dim), "down": p(cfg.mlp_dim, d)})
        else:
            e, i, s = cfg.n_experts, cfg.moe_dim, cfg.n_shared * cfg.moe_dim
            self.mlp = nn.ParameterDict({
                "router": p(e, d, dtype=torch.float32), "bias": p(e, dtype=torch.float32),
                "w13": p(e, 2 * i, d), "w2": p(e, d, i),
                "shared_gate_up": p(d, 2 * s), "shared_down": p(s, d),
            })
        # set by DeepseekLM before each forward: its tally, this layer's row
        # of the expert loads, the forward's route list (or None), and the
        # forward's rope rotations, made by its first layer (None: each call
        # makes its own)
        self.tally = Tally()
        self.loads: torch.Tensor | None = None
        self.routes: list | None = None
        self.rope: dict | None = None

    def make_mixer(self, p) -> None:
        """The token mixer's weights, drawn through ``p(*shape, ...)``: MLA's
        ``attn``."""
        cfg = self.cfg
        d, h = cfg.dim, cfg.heads
        self.attn = nn.ParameterDict({
            "q": p(d, h * cfg.head_dim),
            "kv_a": p(d, cfg.kv_rank + cfg.qk_rope_dim),
            "kv_norm": p(cfg.kv_rank, std=None),
            "kv_b": p(cfg.kv_rank, h * (cfg.qk_nope_dim + cfg.v_dim)),
            "o": p(h * cfg.v_dim, d),
        })

    def qkv(self, x, positions):
        """q and k [B, T, H, qk_nope + qk_rope] (the shared rope key repeated
        over the heads), v [B, T, H, v_dim]."""
        cfg, p = self.cfg, self.attn
        b, t, _ = x.shape
        q = (x @ p["q"]).view(b, t, cfg.heads, cfg.head_dim)
        latent, k_rope = (x @ p["kv_a"]).split([cfg.kv_rank, cfg.qk_rope_dim], dim=-1)
        kv = (rms_norm(p["kv_norm"], latent, KV_NORM_EPS) @ p["kv_b"]).view(b, t, cfg.heads, -1)
        if cfg.nope:
            k = torch.cat([kv[..., : cfg.qk_nope_dim],
                           k_rope[:, :, None, :].expand(b, t, cfg.heads, cfg.qk_rope_dim)], dim=-1)
            return q, k, kv[..., cfg.qk_nope_dim :]
        rot = self.rope.get("rot") if self.rope is not None else None
        if rot is None:
            rot = rope_rotation(positions, cfg.qk_rope_dim, cfg.rope_theta)
            if self.rope is not None:
                self.rope["rot"] = rot
        q_rope = rope_interleaved(q[..., cfg.qk_nope_dim :], rot)
        k_rope = rope_interleaved(k_rope[:, :, None, :], rot)
        q = torch.cat([q[..., : cfg.qk_nope_dim], q_rope], dim=-1)
        k = torch.cat([kv[..., : cfg.qk_nope_dim], k_rope.expand(b, t, cfg.heads, cfg.qk_rope_dim)], dim=-1)
        return q, k, kv[..., cfg.qk_nope_dim :]

    def mlp_out(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP's output [B, T, D] in x's dtype."""
        p, cfg = self.mlp, self.cfg
        if not self.is_moe:
            return swiglu_mlp(x, p["gate_up"], p["down"])
        b, t, d = x.shape
        x2 = x.reshape(b * t, d)
        out, r = moe(x2, {"w": p["router"], "bias": p["bias"]}, p["w13"], p["w2"],
                     lambda y: swiglu_mlp(y, p["shared_gate_up"], p["shared_down"]),
                     top_k=cfg.top_k, scale=cfg.routed_scale, normalize=cfg.norm_topk,
                     tally=self.tally, loads=self.loads)
        if self.routes is not None:
            self.routes.append(r.experts)
        return out.view(b, t, d)

    def mix(self, x, positions, key_mask, causal: bool) -> torch.Tensor:
        """The token mixer, MLA, over the normed x [B, T, D] -> [B, T, D]."""
        cfg = self.cfg
        b, t, _ = x.shape
        q, k, v = self.qkv(x, positions)
        v = F.pad(v, (0, cfg.head_dim - cfg.v_dim))
        out = grouped_attention(q, k, v, key_mask=key_mask, causal=causal, sm_scale=cfg.head_dim**-0.5)
        out = out.view(b, t, cfg.heads, cfg.head_dim)[..., : cfg.v_dim].reshape(b, t, cfg.heads * cfg.v_dim)
        return out @ self.attn["o"]

    def forward(self, h, positions, key_mask, causal: bool, sp=None):
        """[B, T, D] -> (h, None, None): no KV cache is kept."""
        if sp is not None:
            raise NotImplementedError("the DeepSeek decoder has no sequence-parallel path")
        cfg = self.cfg
        h = h + self.mix(self.norm(self.ln1, h, cfg.rms_eps), positions, key_mask, causal)
        return h + self.mlp_out(self.norm(self.ln2, h, cfg.rms_eps)), None, None

    def decode(self, *args, **kwargs):
        raise NotImplementedError("the DeepSeek decoder runs no generation")


class DeepseekLM(RoutedLM):
    """Token embedding table ``embed`` [V, D], ``layers.<i>`` (``layer_cls``),
    ``final_norm``."""

    norm = staticmethod(rms_norm)
    layer_cls = DeepseekLayer

    def __init__(self, cfg: DeepseekConfig, *, gen: torch.Generator | None, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(self.layer_cls(cfg, i, gen=gen, device=device, dtype=dtype)
                                    for i in range(cfg.layers))
        self.embed = param((cfg.vocab_size, cfg.dim), gen, device, dtype)
        self.final_norm = param((cfg.dim,), gen, device, dtype, std=None)
        self.tally = Tally()
        self.expert_loads: torch.Tensor | None = None  # [moe layers, E] int64 on the device
        self.route_sink: list | None = None

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows, unscaled."""
        return self.embed[input_ids.long()]

    def forward(self, inputs_embeds: torch.Tensor, attn_mask: torch.Tensor | None = None,
                causal: bool = True, sp=None) -> torch.Tensor:
        """inputs_embeds [B, T, D] -> final hidden [B, T, D]: causal, with
        ``attn_mask`` [B, T] (nonzero = valid) as a key mask."""
        cfg = self.cfg
        routes = self._routing_state(inputs_embeds.device)
        rope: dict = {}
        for layer in self.layers:
            layer.tally, layer.routes, layer.rope = self.tally, routes, rope
            layer.loads = self.expert_loads[layer.index - cfg.first_dense] if layer.is_moe else None
        return self.hidden_states(inputs_embeds, attn_mask, causal, sp)


def mla_from_hf(w) -> dict[str, torch.Tensor]:
    """An HF MLA's ``self_attn.*`` tensors -> this module's ``attn.*`` names,
    each read through ``w(key, transpose=True)``."""
    return {"attn.q": w("self_attn.q_proj.weight"), "attn.kv_a": w("self_attn.kv_a_proj_with_mqa.weight"),
            "attn.kv_norm": w("self_attn.kv_a_layernorm.weight", False), "attn.kv_b": w("self_attn.kv_b_proj.weight"),
            "attn.o": w("self_attn.o_proj.weight")}


def layer_from_hf(sd: Mapping[str, torch.Tensor], prefix: str, cfg: DeepseekConfig, index: int,
                  dtype) -> dict[str, torch.Tensor]:
    """HF ``DeepseekV3DecoderLayer`` ``prefix.layers.<index>`` tensors ->
    this module's ``layers.<index>.*`` names, on their own device in
    ``dtype`` (the router and its bias in f32)."""
    lp = f"{prefix}.layers.{index}"

    def w(key, t=True):
        x = sd[f"{lp}.{key}"]
        return owned(x.T if t else x, dtype)

    out = {"ln1": w("input_layernorm.weight", False), "ln2": w("post_attention_layernorm.weight", False),
           **mla_from_hf(w)}
    if index < cfg.first_dense:
        out["mlp.gate_up"] = torch.cat([w("mlp.gate_proj.weight"), w("mlp.up_proj.weight")], dim=1)
        out["mlp.down"] = w("mlp.down_proj.weight")
    else:
        out["mlp.router"] = owned(sd[f"{lp}.mlp.gate.weight"], torch.float32)
        out["mlp.bias"] = owned(sd[f"{lp}.mlp.gate.e_score_correction_bias"], torch.float32)
        ex = f"{lp}.mlp.experts"
        out["mlp.w13"] = torch.stack([torch.cat([sd[f"{ex}.{e}.gate_proj.weight"], sd[f"{ex}.{e}.up_proj.weight"]])
                                      for e in range(cfg.n_experts)]).to(dtype)
        out["mlp.w2"] = torch.stack([sd[f"{ex}.{e}.down_proj.weight"] for e in range(cfg.n_experts)]).to(dtype)
        out["mlp.shared_gate_up"] = torch.cat([w("mlp.shared_experts.gate_proj.weight"),
                                               w("mlp.shared_experts.up_proj.weight")], dim=1)
        out["mlp.shared_down"] = w("mlp.shared_experts.down_proj.weight")
    return {f"layers.{index}.{k}": v for k, v in out.items()}
