"""Granite-4.0-H's hybrid decoder: Mamba-2 state-space layers and a few NoPE
grouped-query attention layers, each followed by a mixture-of-experts MLP
with one shared expert; ColPali (``colpali.py``) runs it in place of Gemma.

The equations are those of ``transformers``' ``GraniteMoeHybridModel``
(``torch_forward`` for the Mamba-2 layers):

- the input embeddings (the image features and the token embeddings alike)
  times ``embedding_multiplier``;
- each layer ``h = h + r * mixer(rmsnorm(h))``, then ``h = h + r * (moe(u)
  + shared(u))`` with ``u = rmsnorm(h)`` and ``r`` the
  ``residual_multiplier``; a final RMSNorm. RMSNorm keeps f32 statistics;
- the Mamba-2 mixer (``layer_types`` "mamba"): ``in_proj`` to z
  [d_inner], xBC [d_inner + 2 * state] and dt [heads]; xBC through a causal
  depthwise conv of width ``conv_width`` with bias, then SiLU, split into x,
  B and C (one group); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  the scan of ``ops/ssm.py`` (each head's state [head_dim, state] in f32: the
  kernel on the card); ``y = w * rmsnorm(y * silu(z))`` over all d_inner
  channels in f32; ``out_proj``. Where a key mask is given, the padded
  positions of the mixer's input and of the conv's output are zeroed
  (``apply_mask_to_padding_states``);
- the attention mixer (``layer_types`` "attention"): q, k, v and o without
  bias, ``heads`` query and ``kv_heads`` key/value heads of ``dim / heads``,
  no rotary embedding, scale ``attention_multiplier``, causal with the key
  mask, through ``decoder_attn.grouped_attention`` (the fused kernel on the
  card);
- the MoE: ``ops/moe.py:moe_softmax`` (f32 logits, the top ``top_k`` of
  ``n_experts``, their softmax as the weights), each expert a SwiGLU of
  ``moe_dim`` (``input_linear``: gate then up; ``output_linear``), the shared
  SwiGLU of ``shared_dim`` added in the combine's kernel;
- no LM head is held (ColPali reads the final hidden states).

Departures from the published code, each where a rounding falls:

- RMSNorm rounds ``w * x_normed`` once to the hidden dtype (the published
  norm rounds the normed value, then multiplies by the gain in that dtype);
- the router's product is in f32 (the published one runs in the hidden dtype
  and casts the logits to f32) and the combine's weights stay f32 (the
  published ones are cast to the hidden dtype and summed there);
- the scan's output is rounded to the hidden dtype before the gated norm on
  the card (the kernel writes y in x's dtype; the published ``torch_forward``
  keeps y in f32 up to ``out_proj``);
- the padding mask is applied for any batch (the published code skips it for
  a single sequence or when every position is valid, where it changes
  nothing but a single left-padded row).

Weights: dense projections ``[d_in, d_out]`` (the port's layout); the conv
``conv_w`` [conv_dim, 1, conv_width] and ``conv_b``; ``dt_bias``, ``A_log`` and
``D`` [heads]; the gated norm's ``norm`` [d_inner]; the router ``[E, D]`` in
f32; the experts in the checkpoint's layout, ``w13`` ``[E, 2I, D]`` (gate then
up) and ``w2`` ``[E, D, I]``. :func:`layer_from_hf` converts an HF
``GraniteMoeHybridDecoderLayer`` on the tensors' own device.

The model keeps a :class:`~..utils.profiling.Tally` (``tally``): the MoE's
spans and ``moe.routed_rows`` as ``models/deepseek.py`` keeps them, and the
Mamba-2 layers' spans ``ssm.in`` (``in_proj``, the conv, dt), ``ssm.scan``
and ``ssm.out`` (the gated norm and ``out_proj``) and count ``ssm.tokens``
(batch rows times length, a Mamba-2 layer). Expert loads and the route sink
are ``decoder.RoutedLM``'s (``expert_loads``, :meth:`take_expert_loads`,
``route_sink``), one row a MoE layer: here every layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import moe_softmax
from ..ops.ssm import scan
from ..utils.profiling import Tally
from .decoder import DecoderLayer, RoutedLM, owned, param, rms_norm, swiglu_mlp
from .decoder_attn import grouped_attention


@dataclass(frozen=True)
class GraniteConfig:
    vocab_size: int
    dim: int
    layer_types: tuple[str, ...]  # "mamba" or "attention", a layer
    heads: int
    kv_heads: int
    moe_dim: int  # one expert's width (``intermediate_size``)
    n_experts: int
    top_k: int
    shared_dim: int  # the shared expert's width (``shared_intermediate_size``)
    ssm_heads: int
    ssm_head_dim: int
    state: int  # ``mamba_d_state``
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256  # the plain scan's chunk (``mamba_chunk_size``)
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    attention_multiplier: float = 1.0 / 128
    rms_eps: float = 1e-5

    def __post_init__(self):
        if self.ssm_heads * self.ssm_head_dim != self.d_inner:
            raise ValueError(f"Granite decoder: {self.ssm_heads} heads of {self.ssm_head_dim} are not "
                             f"d_inner {self.d_inner}")

    @property
    def layers(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        """The attention layers' head size."""
        return self.dim // self.heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def conv_dim(self) -> int:
        """x, B and C, the channels the conv runs over."""
        return self.d_inner + 2 * self.state

    @property
    def mamba_layers(self) -> int:
        return self.layer_types.count("mamba")

    @property
    def moe_layers(self) -> int:
        return self.layers


_HF_KEYS = {"vocab_size": "vocab_size", "dim": "hidden_size", "heads": "num_attention_heads",
            "kv_heads": "num_key_value_heads", "moe_dim": "intermediate_size", "n_experts": "num_local_experts",
            "top_k": "num_experts_per_tok", "shared_dim": "shared_intermediate_size", "ssm_heads": "mamba_n_heads",
            "ssm_head_dim": "mamba_d_head", "state": "mamba_d_state", "conv_width": "mamba_d_conv",
            "expand": "mamba_expand", "chunk": "mamba_chunk_size", "embedding_multiplier": "embedding_multiplier",
            "residual_multiplier": "residual_multiplier", "attention_multiplier": "attention_multiplier",
            "rms_eps": "rms_norm_eps"}


def granite_config_from_hf(c) -> GraniteConfig:
    """A ``GraniteConfig`` from an HF ``GraniteMoeHybridConfig`` (or any
    object or mapping with its keys). Raises on what this module does not
    run: rotary embeddings, biased projections, more than one group, no
    experts, an activation other than silu."""
    get = c.get if isinstance(c, Mapping) else lambda k, d=None: getattr(c, k, d)
    want = {"position_embedding_type": "nope", "attention_bias": False, "mamba_proj_bias": False,
            "mamba_conv_bias": True, "mamba_n_groups": 1, "hidden_act": "silu", "normalization_function": "rmsnorm"}
    for key, value in want.items():
        if get(key, value) != value:
            raise ValueError(f"Granite decoder: {key}={get(key)!r} is not supported (only {value!r})")
    if not get("num_local_experts") or not get("num_experts_per_tok"):
        raise ValueError("Granite decoder: only a MoE block in every layer is supported")
    types = tuple(get("layer_types") or get("layers_block_type"))
    if set(types) - {"mamba", "attention"}:
        raise ValueError(f"Granite decoder: unknown layer types {sorted(set(types))}")
    return GraniteConfig(layer_types=types, **{k: get(hf) for k, hf in _HF_KEYS.items()})


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``w * rmsnorm(y * silu(z))`` over the last axis, in f32, rounded once
    to z's dtype (``GraniteMoeHybridRMSNormGated``)."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return (w.float() * g).to(z.dtype)


class GraniteLayer(DecoderLayer):
    """``ln1``, the mixer (``mamba.{in_proj,conv_w,conv_b,dt_bias,A_log,D,
    norm,out_proj}`` or ``attn.{q,k,v,o}``), ``ln2`` and ``mlp.{router,w13,
    w2,shared_gate_up,shared_down}``."""

    norm = staticmethod(rms_norm)

    def __init__(self, cfg: GraniteConfig, index: int, *, gen, device, dtype):
        super().__init__()
        self.cfg, self.index = cfg, index
        self.kind = cfg.layer_types[index]
        d = cfg.dim

        def p(*shape, **kw):
            return param(shape, gen, device, kw.pop("dtype", dtype), **kw)

        self.ln1, self.ln2 = p(d, std=None), p(d, std=None)
        if self.kind == "mamba":
            self.mamba = nn.ParameterDict({
                "in_proj": p(d, cfg.d_inner + cfg.conv_dim + cfg.ssm_heads),
                "conv_w": p(cfg.conv_dim, 1, cfg.conv_width), "conv_b": p(cfg.conv_dim),
                "dt_bias": p(cfg.ssm_heads), "A_log": p(cfg.ssm_heads), "D": p(cfg.ssm_heads, std=None),
                "norm": p(cfg.d_inner, std=None), "out_proj": p(cfg.d_inner, d),
            })
        else:
            hd = cfg.head_dim
            self.attn = nn.ParameterDict({"q": p(d, cfg.heads * hd), "k": p(d, cfg.kv_heads * hd),
                                          "v": p(d, cfg.kv_heads * hd), "o": p(cfg.heads * hd, d)})
        self.mlp = nn.ParameterDict({
            "router": p(cfg.n_experts, d, dtype=torch.float32),
            "w13": p(cfg.n_experts, 2 * cfg.moe_dim, d), "w2": p(cfg.n_experts, d, cfg.moe_dim),
            "shared_gate_up": p(d, 2 * cfg.shared_dim), "shared_down": p(cfg.shared_dim, d),
        })
        # set by GraniteLM before each forward: its tally, this layer's row
        # of the expert loads and the forward's route list (or None)
        self.tally = Tally()
        self.loads: torch.Tensor | None = None
        self.routes: list | None = None

    def ssm(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        """The Mamba-2 mixer over the normed x [B, T, D] -> [B, T, D]."""
        cfg, p, tally = self.cfg, self.mamba, self.tally
        b, t, _ = x.shape
        mask = None if key_mask is None else key_mask[:, :, None].to(x.dtype)
        with tally.span("ssm.in"):
            if mask is not None:
                x = x * mask
            z, xbc, dt = (x @ p["in_proj"]).split([cfg.d_inner, cfg.conv_dim, cfg.ssm_heads], dim=-1)
            xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"], p["conv_b"], padding=cfg.conv_width - 1,
                           groups=cfg.conv_dim)
            xbc = F.silu(xbc[..., :t].transpose(1, 2).contiguous(), inplace=True)  # [B, T, conv_dim]
            if mask is not None:
                xbc = xbc * mask
            xs, bm, cm = xbc.split([cfg.d_inner, cfg.state, cfg.state], dim=-1)
            dt = F.softplus(dt + p["dt_bias"])
            a = -torch.exp(p["A_log"].float())
        with tally.span("ssm.scan"):
            y = scan(xs.unflatten(-1, (cfg.ssm_heads, cfg.ssm_head_dim)), dt, a, bm, cm, p["D"], chunk=cfg.chunk)
        tally.count("ssm.tokens", b * t)
        with tally.span("ssm.out"):
            return gated_rms_norm(y.flatten(2), z, p["norm"], cfg.rms_eps) @ p["out_proj"]

    def attention(self, x: torch.Tensor, key_mask: torch.Tensor | None, causal: bool) -> torch.Tensor:
        """The NoPE attention mixer over the normed x [B, T, D] -> [B, T, D]."""
        cfg, p = self.cfg, self.attn
        b, t, _ = x.shape
        q = (x @ p["q"]).view(b, t, cfg.heads, cfg.head_dim)
        k = (x @ p["k"]).view(b, t, cfg.kv_heads, cfg.head_dim)
        v = (x @ p["v"]).view(b, t, cfg.kv_heads, cfg.head_dim)
        out = grouped_attention(q, k, v, key_mask=key_mask, causal=causal, sm_scale=cfg.attention_multiplier)
        return out @ p["o"]

    def mlp_out(self, x: torch.Tensor) -> torch.Tensor:
        """The routed experts plus the shared expert, [B, T, D] in x's dtype."""
        p = self.mlp
        b, t, d = x.shape
        out, r = moe_softmax(x.reshape(b * t, d), p["router"], p["w13"], p["w2"],
                             lambda y: swiglu_mlp(y, p["shared_gate_up"], p["shared_down"]),
                             top_k=self.cfg.top_k, tally=self.tally, loads=self.loads)
        if self.routes is not None:
            self.routes.append(r.experts)
        return out.view(b, t, d)

    def forward(self, h, positions, key_mask, causal: bool, sp=None):
        """[B, T, D] -> (h, None, None): no cache is kept."""
        if sp is not None:
            raise NotImplementedError("the Granite decoder has no sequence-parallel path")
        cfg = self.cfg
        x = self.norm(self.ln1, h, cfg.rms_eps)
        mixed = self.ssm(x, key_mask) if self.kind == "mamba" else self.attention(x, key_mask, causal)
        h = h + mixed * cfg.residual_multiplier
        return h + self.mlp_out(self.norm(self.ln2, h, cfg.rms_eps)) * cfg.residual_multiplier, None, None

    def decode(self, *args, **kwargs):
        raise NotImplementedError("the Granite decoder runs no generation")


class GraniteLM(RoutedLM):
    """Token embedding table ``embed`` [V, D], ``layers.<i>``, ``final_norm``."""

    norm = staticmethod(rms_norm)

    def __init__(self, cfg: GraniteConfig, *, gen: torch.Generator | None, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(GraniteLayer(cfg, i, gen=gen, device=device, dtype=dtype)
                                    for i in range(cfg.layers))
        self.embed = param((cfg.vocab_size, cfg.dim), gen, device, dtype)
        self.final_norm = param((cfg.dim,), gen, device, dtype, std=None)
        self.tally = Tally()
        self.expert_loads: torch.Tensor | None = None  # [moe layers, E] int64 on the device
        self.route_sink: list | None = None

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows, unscaled: :meth:`forward` scales every input."""
        return self.embed[input_ids.long()]

    def forward(self, inputs_embeds: torch.Tensor, attn_mask: torch.Tensor | None = None,
                causal: bool = True, sp=None) -> torch.Tensor:
        """inputs_embeds [B, T, D] -> final hidden [B, T, D]: the inputs times
        ``embedding_multiplier``, causal, with ``attn_mask`` [B, T] (nonzero =
        valid) as a key mask and the Mamba-2 layers' padding mask."""
        cfg = self.cfg
        routes = self._routing_state(inputs_embeds.device)
        for layer in self.layers:
            layer.tally, layer.routes, layer.loads = self.tally, routes, self.expert_loads[layer.index]
        return self.hidden_states(inputs_embeds * cfg.embedding_multiplier, attn_mask, causal, sp)


def layer_from_hf(sd: Mapping[str, torch.Tensor], prefix: str, cfg: GraniteConfig, index: int,
                  dtype) -> dict[str, torch.Tensor]:
    """HF ``GraniteMoeHybridDecoderLayer`` ``prefix.layers.<index>`` tensors
    -> this module's ``layers.<index>.*`` names, on their own device in
    ``dtype`` (the router in f32)."""
    lp = f"{prefix}.layers.{index}"

    def w(key, t=True):
        x = sd[f"{lp}.{key}"]
        return owned(x.T if t else x, dtype)

    out = {"ln1": w("input_layernorm.weight", False), "ln2": w("post_attention_layernorm.weight", False)}
    if cfg.layer_types[index] == "mamba":
        out.update({"mamba.in_proj": w("mamba.in_proj.weight"), "mamba.out_proj": w("mamba.out_proj.weight"),
                    **{f"mamba.{k}": w(f"mamba.{hf}", False) for k, hf in (
                        ("conv_w", "conv1d.weight"), ("conv_b", "conv1d.bias"), ("dt_bias", "dt_bias"),
                        ("A_log", "A_log"), ("D", "D"), ("norm", "norm.weight"))}})
    else:
        out.update({f"attn.{n}": w(f"self_attn.{n}_proj.weight") for n in ("q", "k", "v", "o")})
    moe = f"{lp}.block_sparse_moe"
    out.update({"mlp.router": owned(sd[f"{moe}.router.layer.weight"], torch.float32),
                "mlp.w13": owned(sd[f"{moe}.input_linear.weight"], dtype),
                "mlp.w2": owned(sd[f"{moe}.output_linear.weight"], dtype),
                "mlp.shared_gate_up": w("shared_mlp.input_linear.weight"),
                "mlp.shared_down": w("shared_mlp.output_linear.weight")})
    return {f"layers.{index}.{k}": v for k, v in out.items()}
