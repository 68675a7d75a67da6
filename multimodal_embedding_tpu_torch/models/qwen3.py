"""Qwen3 decoder, the reference's RL base model family (Qwen/Qwen3-14B).

Counterpart of ``multimodal_embedding_tpu/models/qwen3.py``: ``qwen3_apply``
as ``Qwen3.forward``, ``qwen3_embed`` as ``embed_tokens``, and
``qwen3_lm_logits``, ``qwen3_prefill``, ``qwen3_decode_step`` as
``lm_logits``, ``prefill``, ``decode_step`` (from ``models/decoder.py``).
The HF ``Qwen3ForCausalLM`` semantics, as in the JAX package:

- plain token embeddings (no sqrt(dim) scaling);
- RMSNorm with f32 statistics, the normed value cast to x's dtype before a
  plain ``w`` gain multiplied in x's dtype (HF Qwen3RMSNorm; Gemma's gain is
  ``1 + w`` in f32);
- grouped-query attention (``models/decoder_attn.py``) with a per-head
  QK-RMSNorm over head_dim between the q/k projections and rope;
- rotary embeddings (rotate-half, theta 1e6) from ``models/gemma.py``;
- a SwiGLU MLP, down(silu(gate(x)) * up(x)), gate and up kept in f32 and
  rounded once before ``down``;
- an untied LM head ``lm_head`` [D, V] (Qwen3-14B), or the tied
  ``embed`` transposed; logits accumulated and kept in f32.

Weights keep the JAX layouts (a projection is ``[d_in, d_out]``), the
``[L, ...]``-stacked layers unrolled into ``layers.<i>``; in bf16 the q/k/v
products are rounded to bf16 as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
from torch import nn

from .convert import _t, stack_layers
from .decoder import DecoderLayer, DecoderLM
from .gemma import _rope
from .layers import matmul_f32
from .params import load_tree
from .towers import _normal


@dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False


def qwen3_rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """HF Qwen3RMSNorm: f32 statistics, cast back to x's dtype, then the gain
    in x's dtype."""
    xf = x.float()
    y = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)
    return y * w.to(x.dtype)


def _ones(dim: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)


class Qwen3Layer(DecoderLayer):
    """One decoder layer: ``ln1``, ``attn.{q,k,v,o,q_norm,k_norm}``, ``ln2``,
    ``mlp.{gate,up,down}`` (the JAX tree's names)."""

    norm = staticmethod(qwen3_rms_norm)

    def __init__(self, cfg: Qwen3Config, *, gen: torch.Generator | None, device, dtype):
        super().__init__()
        s = 0.02
        self.cfg = cfg
        qd, kvd = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        self.ln1 = _ones(cfg.dim, device, dtype)
        self.attn = nn.ParameterDict({
            "q": _normal((cfg.dim, qd), s, gen, device, dtype),
            "k": _normal((cfg.dim, kvd), s, gen, device, dtype),
            "v": _normal((cfg.dim, kvd), s, gen, device, dtype),
            "o": _normal((qd, cfg.dim), s, gen, device, dtype),
            "q_norm": _ones(cfg.head_dim, device, dtype),
            "k_norm": _ones(cfg.head_dim, device, dtype),
        })
        self.ln2 = _ones(cfg.dim, device, dtype)
        self.mlp = nn.ParameterDict({
            "gate": _normal((cfg.dim, cfg.mlp_dim), s, gen, device, dtype),
            "up": _normal((cfg.dim, cfg.mlp_dim), s, gen, device, dtype),
            "down": _normal((cfg.mlp_dim, cfg.dim), s, gen, device, dtype),
        })

    def qkv(self, x, positions):
        """``_qkv``: projections, the per-head QK-RMSNorm, then rope."""
        cfg, p = self.cfg, self.attn
        b, t, _ = x.shape
        q = (x @ p["q"]).reshape(b, t, -1, cfg.head_dim)
        k = (x @ p["k"]).reshape(b, t, -1, cfg.head_dim)
        v = (x @ p["v"]).reshape(b, t, -1, cfg.head_dim)
        q = qwen3_rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = qwen3_rms_norm(p["k_norm"], k, cfg.rms_eps)
        return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v

    def mlp_hidden(self, x: torch.Tensor) -> torch.Tensor:
        p = self.mlp
        h = torch.nn.functional.silu(matmul_f32(x, p["gate"])) * matmul_f32(x, p["up"])
        return h.to(x.dtype)


class Qwen3(DecoderLM):
    """``embed`` [V, D], ``layers.<i>``, ``final_norm`` and, untied,
    ``lm_head`` [D, V]. Weights are drawn from ``gen`` on ``device`` in
    ``dtype`` (normal, std 0.02; norms ones, as ``qwen3_init``); on ``meta``
    (``gen`` None) the module holds shapes only."""

    norm = staticmethod(qwen3_rms_norm)

    def __init__(self, cfg: Qwen3Config, *, gen: torch.Generator | None, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Qwen3Layer(cfg, gen=gen, device=device, dtype=dtype) for _ in range(cfg.layers))
        self.embed = _normal((cfg.vocab_size, cfg.dim), 0.02, gen, device, dtype)
        self.final_norm = _ones(cfg.dim, device, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _normal((cfg.dim, cfg.vocab_size), 0.02, gen, device, dtype)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed[input_ids.long()]

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def forward(self, inputs_embeds: torch.Tensor, attn_mask: torch.Tensor | None = None,
                causal: bool = True) -> torch.Tensor:
        """``qwen3_apply``: inputs_embeds [B, T, D] -> final hidden [B, T, D]
        (post final norm). attn_mask [B, T] (nonzero = valid) is a key mask
        with positions cumsum(mask) - 1; without one every key is valid."""
        return self.hidden_states(inputs_embeds, attn_mask, causal)


def qwen3_from_params(tree: Mapping[str, Any], cfg: Qwen3Config, *, device, dtype=torch.float32) -> Qwen3:
    """A ``Qwen3`` holding a JAX-layout param tree's weights in ``dtype``
    (built on ``meta``: the tree's tensors are the only copy on ``device``)."""
    return load_tree(Qwen3(cfg, gen=None, device="meta", dtype=dtype), tree, dtype, device=device)


# --- HF checkpoint conversion -------------------------------------------------


def qwen3_config_from_hf(hf_cfg) -> Qwen3Config:
    """transformers Qwen3Config -> Qwen3Config (Qwen/Qwen3-14B config.json)."""
    return Qwen3Config(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers,
        heads=hf_cfg.num_attention_heads,
        kv_heads=hf_cfg.num_key_value_heads,
        head_dim=getattr(hf_cfg, "head_dim", hf_cfg.hidden_size // hf_cfg.num_attention_heads),
        mlp_dim=hf_cfg.intermediate_size,
        rope_theta=float(hf_cfg.rope_theta),
        rms_eps=float(hf_cfg.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
    )


def qwen3_params_from_hf(sd: Mapping, cfg: Qwen3Config) -> dict:
    """HF Qwen3ForCausalLM state dict -> the JAX package's param tree (numpy,
    layers stacked ``[L, ...]``); ``qwen3_from_params`` carries it in."""
    layers = []
    for i in range(cfg.layers):
        lp = f"model.layers.{i}"
        layers.append({
            "ln1": _t(sd[f"{lp}.input_layernorm.weight"]),
            "attn": {
                "q": _t(sd[f"{lp}.self_attn.q_proj.weight"]).T,
                "k": _t(sd[f"{lp}.self_attn.k_proj.weight"]).T,
                "v": _t(sd[f"{lp}.self_attn.v_proj.weight"]).T,
                "o": _t(sd[f"{lp}.self_attn.o_proj.weight"]).T,
                "q_norm": _t(sd[f"{lp}.self_attn.q_norm.weight"]),
                "k_norm": _t(sd[f"{lp}.self_attn.k_norm.weight"]),
            },
            "ln2": _t(sd[f"{lp}.post_attention_layernorm.weight"]),
            "mlp": {
                "gate": _t(sd[f"{lp}.mlp.gate_proj.weight"]).T,
                "up": _t(sd[f"{lp}.mlp.up_proj.weight"]).T,
                "down": _t(sd[f"{lp}.mlp.down_proj.weight"]).T,
            },
        })
    params = {
        "embed": _t(sd["model.embed_tokens.weight"]),
        "layers": stack_layers(layers),
        "final_norm": _t(sd["model.norm.weight"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _t(sd["lm_head.weight"]).T
    return params


# Qwen/Qwen3-14B config.json (the reference's RL base model)
QWEN3_14B = Qwen3Config(
    vocab_size=151936,
    dim=5120,
    layers=40,
    heads=40,
    kv_heads=8,
    head_dim=128,
    mlp_dim=17408,
    rope_theta=1e6,
    rms_eps=1e-6,
    tie_embeddings=False,
)
