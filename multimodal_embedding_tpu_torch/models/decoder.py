"""The decoder LMs' shared steps: a layer, the forward, and generation's
prefill and decode over a static KV cache.

The JAX package writes these steps once per model: ``gemma_apply``,
``gemma_lm_logits``, ``gemma_prefill`` and ``gemma_decode_step``
(``models/gemma.py:102-224``), and ``qwen3_apply``, ``qwen3_lm_logits``,
``qwen3_prefill`` and ``qwen3_decode_step`` (``models/qwen3.py:103-208``).
They differ only in the embedding, the RMSNorm, the q/k/v projections and the
MLP, which each model's module gives (``models/gemma.py``,
``models/qwen3.py``); Gemma and Qwen3 inherit the rest from here.

The two MoE decoders (``models/deepseek.py``, ``models/granite.py``) take
from here :class:`RoutedLM`, the base that keeps each expert's routed rows
and each forward's chosen experts, and the pieces both build their layers
from: :func:`rms_norm`, :func:`swiglu_mlp`, :func:`param` and :func:`owned`.

The KV cache is ``{"k", "v"}``, each ``[L, B, KVH, cache_len, Dh]`` in the
model dtype: the JAX ``[L, B, cache_len, KVH, Dh]`` with the token and head
axes swapped, so a decode step reads each head's keys as one contiguous
``[cache_len, Dh]`` block. The prefill allocates it, zeros past the prompt
(``jnp.pad``), and each decode step writes its token's slot in place where
JAX returns a new cache (``dynamic_update_slice``).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn

from ..ops.moe import swiglu
from ..parallel.mesh import copy_to_model, reduce_from_model
from ..parallel.sp import shard_tokens
from .decoder_attn import decode_attention, grouped_attention
from .layers import matmul_f32


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics and a ``w`` gain, rounded once to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``down(silu(x @ gate) * (x @ up))``, the activation in f32 rounded once
    (``ops/moe.py:swiglu``: the kernel on the card)."""
    return swiglu(x @ gate_up) @ down


def param(shape, gen, device, dtype, *, std: float | None = 0.02) -> nn.Parameter:
    """N(0, std) drawn from ``gen`` (ones where std is None), or an empty
    tensor on ``meta``."""
    if torch.device(device).type == "meta":
        t = torch.empty(shape, device=device, dtype=dtype)
    elif std is None:
        t = torch.ones(shape, device=device, dtype=dtype)
    else:
        t = (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def owned(x: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy of x in ``dtype`` on its device, sharing no storage
    with it, so a converted weight never keeps its source alive."""
    return torch.empty(x.shape, dtype=dtype, device=x.device).copy_(x)


def _row_product(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w``; where ``w`` is row-split over the model axis (``group``
    set), each rank's partial product accumulated in f32, summed over the
    axis in f32 and rounded once to x's dtype, as one rank's product is. (A
    sum of partials rounded to bf16 rounds twice more: on the H100 it moved
    the GRPO loss of Qwen3-14B cut to 4 layers 2.6% from one rank's, the f32
    sum 0.4%.)"""
    if group is None:
        return x @ w
    return reduce_from_model(matmul_f32(x, w), group).to(x.dtype)


class DecoderLayer(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn.{q,k,v,o,...}``, ``ln2``,
    ``mlp.{...}``. A subclass gives ``norm`` (its RMSNorm, ``(w, x, eps)``),
    ``qkv`` (projections, any head norm and rope: q [B, T, H, Dh], k and v
    [B, T, KVH, Dh], H and KVH read off the weights) and ``mlp_hidden`` (the
    activated MLP hidden in x's dtype, which ``mlp.down`` projects).

    Under tensor parallelism ``parallel/tp.py`` keeps this rank's heads and
    MLP columns and sets ``attn_group`` / ``mlp_group``, the model-axis group
    of each split side: its normed input enters the column-split projections
    through ``copy_to_model`` (the input's gradient summed over the group),
    and its row-split ``o`` / ``down`` product leaves through
    ``reduce_from_model`` (summed in f32, :func:`_row_product`). A side kept
    whole has no group and takes neither. ``attn_split`` records the slice of
    the attention this rank kept (``parallel/tp.py:AttentionSplit``; None
    while it is whole)."""

    cfg: Any
    norm: Any
    attn_group = None
    mlp_group = None
    attn_split = None

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        raise NotImplementedError

    def mlp_hidden(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, h, positions, key_mask, causal: bool, sp=None):
        """[B, T, D] -> (h, k, v): the layer's output and its rope'd keys and
        values, which the prefill caches. With ``sp`` (a sequence-parallel
        mesh) h, positions and key_mask are this rank's token shard."""
        eps = self.cfg.rms_eps
        q, k, v = self.qkv(copy_to_model(self.norm(self.ln1, h, eps), self.attn_group), positions)
        out = grouped_attention(q, k, v, key_mask=key_mask, causal=causal,
                                sm_scale=1.0 / math.sqrt(self.cfg.head_dim), sp=sp)
        h = h + _row_product(out, self.attn["o"], self.attn_group)
        x = copy_to_model(self.norm(self.ln2, h, eps), self.mlp_group)
        return h + _row_product(self.mlp_hidden(x), self.mlp["down"], self.mlp_group), k, v

    def decode(self, h, positions, k_cache, v_cache, write_idx: int, cache_valid) -> torch.Tensor:
        """One token a row, h [B, 1, D]: writes its k and v at cache slot
        ``write_idx`` of this layer's caches [B, KVH, S, Dh], then attends
        over the slots ``cache_valid`` [B, S] marks."""
        eps = self.cfg.rms_eps
        q, k, v = self.qkv(self.norm(self.ln1, h, eps), positions)
        k_cache[:, :, write_idx] = k[:, 0]
        v_cache[:, :, write_idx] = v[:, 0]
        h = h + _row_product(decode_attention(q, k_cache, v_cache, cache_valid), self.attn["o"], self.attn_group)
        return h + _row_product(self.mlp_hidden(self.norm(self.ln2, h, eps)), self.mlp["down"], self.mlp_group)


class DecoderLM(nn.Module):
    """``embed`` [V, D], ``layers.<i>`` (:class:`DecoderLayer`s),
    ``final_norm``. A subclass gives ``norm``, ``embed_tokens`` and
    ``head`` (the LM head, [D, V])."""

    cfg: Any
    norm: Any

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def head(self) -> torch.Tensor:
        raise NotImplementedError

    def hidden_states(self, x: torch.Tensor, attn_mask: torch.Tensor | None, causal: bool,
                      sp=None) -> torch.Tensor:
        """inputs_embeds [B, T, D] -> final hidden [B, T, D]. attn_mask [B, T]
        (nonzero = valid) is a key mask with positions cumsum(mask) - 1 (left
        padding); without one every key is valid. With ``sp`` (a
        sequence-parallel mesh whose model axis divides T) the stack runs on
        this rank's token shard and returns it, [B, T / n, D]; the positions
        are counted over the whole sequence first."""
        b, t, _ = x.shape
        if attn_mask is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
            key_mask = None
        else:
            positions = torch.cumsum(attn_mask.long(), dim=-1) - 1
            key_mask = attn_mask > 0
        if sp is not None:
            x, positions = shard_tokens(x, sp), shard_tokens(positions, sp)
            key_mask = None if key_mask is None else shard_tokens(key_mask, sp)
        for layer in self.layers:
            x = layer(x, positions, key_mask, causal, sp)[0]
        return self.norm(self.final_norm, x, self.cfg.rms_eps)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, T, D] -> logits [B, T, V] in f32: the head in the
        hidden dtype, the product accumulated and kept in f32."""
        return matmul_f32(hidden, self.head())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def prefill(self, input_ids: torch.Tensor, attn_mask: torch.Tensor, cache_len: int):
        """Causal prefill of left-padded prompts ids [B, T] with mask [B, T]
        -> (final hidden [B, T, D], KV cache with slots 0..T-1 filled). The
        cache holds the KV heads the layers' keys carry: this rank's under
        tensor parallelism."""
        cfg = self.cfg
        b, t = input_ids.shape
        positions = torch.cumsum(attn_mask.long(), dim=-1) - 1
        key_mask = attn_mask > 0
        x = self.embed_tokens(input_ids)
        kv = None
        for i, layer in enumerate(self.layers):
            x, k, v = layer(x, positions, key_mask, True)
            if kv is None:
                shape = (cfg.layers, b, k.shape[2], cache_len, cfg.head_dim)
                kv = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
            kv["k"][i, :, :, :t] = k.transpose(1, 2)
            kv["v"][i, :, :, :t] = v.transpose(1, 2)
        return self.norm(self.final_norm, x, cfg.rms_eps), kv

    def decode_step(self, kv: dict, token: torch.Tensor, pos: torch.Tensor, write_idx: int,
                    cache_valid: torch.Tensor):
        """One autoregressive step: token [B] at rope position pos [B],
        written at cache slot ``write_idx``, attending over the slots
        ``cache_valid`` [B, cache_len] marks (this one included). Returns
        (logits [B, V] f32, kv), the cache updated in place."""
        x = self.embed_tokens(token[:, None])
        positions = pos[:, None]
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, positions, kv["k"][i], kv["v"][i], write_idx, cache_valid)
        x = self.norm(self.final_norm, x, self.cfg.rms_eps)
        return self.lm_logits(x)[:, 0], kv


class RoutedLM(DecoderLM):
    """A decoder whose MoE layers report their routing: each expert's routed
    rows a MoE layer on the device (``expert_loads`` [moe layers, E]) and,
    where ``route_sink`` is a list, each forward's chosen experts. A subclass
    has ``cfg.moe_layers`` and ``cfg.n_experts``."""

    expert_loads: torch.Tensor | None = None
    route_sink: list | None = None

    def take_expert_loads(self) -> np.ndarray | None:
        """Each expert's routed rows a MoE layer since the last call, [moe
        layers, E] int64 on the host (a read of the device: call it after a
        barrier), the device counts then zeroed; None before any forward."""
        if self.expert_loads is None:
            return None
        out = self.expert_loads.cpu().numpy().copy()
        with torch.inference_mode():  # the counts are made under the engine's inference mode
            self.expert_loads.zero_()
        return out

    def _routing_state(self, dev: torch.device) -> list | None:
        """Before a forward on ``dev``: the expert loads made there where they
        are not, and the forward's route list appended to the sink (None
        without one)."""
        if self.expert_loads is None or self.expert_loads.device != dev:
            self.expert_loads = torch.zeros(self.cfg.moe_layers, self.cfg.n_experts, dtype=torch.int64, device=dev)
        if self.route_sink is None:
            return None
        routes: list = []
        self.route_sink.append(routes)
        return routes
