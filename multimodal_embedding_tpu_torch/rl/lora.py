"""LoRA adapters for the decoder LMs: an init, the merge
(``merge_and_unload``) that serving runs, and the merged view that training
differentiates.

Counterpart of ``multimodal_embedding_tpu/rl/lora.py`` (``LoraConfig`` :23,
``lora_init`` :29, ``lora_merge`` :44, ``apply_lora`` :59). Adapters are a
tree ``{target: {"a": [L, d_in, r], "b": [L, r, d_out]}}`` for the
projections ``layers.<i>.attn.{q,k,v,o}`` (torch tensors, or numpy arrays as
an adapters ``.npz`` holds them). Both fold ``(a @ b) * alpha / r``, computed
in f32, cast to the weight's dtype and added in that dtype. ``lora_merge``
builds, without a graph, a new module that shares every other tensor with
the base; ``apply_lora`` returns only the merged q/k/v/o tensors, which
``torch.func.functional_call`` puts in the base's place for one forward, so
the gradient reaches the adapters and the base stays frozen.

Over a tensor-parallel base (``parallel/tp.py:shard_params_tp``) the adapters
stay whole, the same on every rank; each rank folds the slice of ``a @ b``
that matches the slice of the weight it kept (the layer's ``attn_split``):
``a @ b[:, cols]`` for q, k and v, ``a[rows] @ b`` for o, and the whole
product where the attention stayed whole. The gradient of each adapter is
then this rank's part (zeros outside its slice of ``b`` or ``a``), which the
trainer sums over the model axis (``rl/grpo.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.decoder import DecoderLM

TARGETS = ("q", "k", "v", "o")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: int = 32
    targets: tuple[str, ...] = TARGETS


def _target_shape(mcfg, name: str) -> tuple[int, int]:
    """[d_in, d_out] of a target projection of the whole model."""
    q, kv = mcfg.heads * mcfg.head_dim, mcfg.kv_heads * mcfg.head_dim
    return {"q": (mcfg.dim, q), "k": (mcfg.dim, kv), "v": (mcfg.dim, kv), "o": (q, mcfg.dim)}[name]


def _fold(layer, name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for this rank's slice of the layer's ``name`` projection."""
    split = layer.attn_split
    if split is not None:
        if name == "o":
            a = a[split.q]
        else:
            b = b[:, split.q if name == "q" else split.kv]
    return a @ b


def lora_init(base: DecoderLM, cfg: LoraConfig, *, generator: torch.Generator, dtype=torch.float32) -> dict:
    """Adapters for each target projection [d_in, d_out] of every layer (the
    whole model's shapes, from its config, on every rank of a split base):
    a [L, d_in, r] normal / r, b [L, r, d_out] zeros (the merge starts as the
    identity), on the base's device."""
    adapters = {}
    n_layers = len(base.layers)
    for name in cfg.targets:
        d_in, d_out = _target_shape(base.cfg, name)
        a = torch.randn((n_layers, d_in, cfg.rank), generator=generator, device=base.device) * (1.0 / cfg.rank)
        adapters[name] = {"a": a.to(dtype),
                          "b": torch.zeros((n_layers, cfg.rank, d_out), device=base.device, dtype=dtype)}
    return adapters


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def apply_lora(base: DecoderLM, adapters: dict, cfg: LoraConfig) -> dict[str, torch.Tensor]:
    """The merged view for the forward pass: ``{"layers.<i>.attn.<target>":
    W + ((a[i] @ b[i]) * alpha / r).to(W.dtype)}``, differentiable with
    respect to adapters given as f32 tensors on the base's device, the base
    weights constants. Run the base on it with
    ``torch.func.functional_call(base, weights, args)``."""
    scale = cfg.alpha / cfg.rank
    weights = {}
    for name, ab in adapters.items():
        a, b = _f32(ab["a"], base.device), _f32(ab["b"], base.device)
        for i, layer in enumerate(base.layers):
            w = layer.attn[name]
            weights[f"layers.{i}.attn.{name}"] = w + (_fold(layer, name, a[i], b[i]) * scale).to(w.dtype)
    return weights


@torch.no_grad()
def lora_merge(base: DecoderLM, adapters: dict, cfg: LoraConfig) -> DecoderLM:
    """A module of the base's type and dtype with each adapter folded into its
    projection; every other tensor is the base's own (no copy). A split base
    gives a module split the same way."""
    from ..parallel.tp import shard_params_tp

    state = {**base.state_dict(), **apply_lora(base, adapters, cfg)}
    merged = type(base)(base.cfg, gen=None, device="meta", dtype=base.embed.dtype)
    mesh = getattr(base, "tp_mesh", None)
    if mesh is not None:
        shard_params_tp(merged, mesh)
    merged.load_state_dict(state, strict=True, assign=True)
    return merged


# backwards-compatible name from when Gemma was the only decoder
apply_lora_to_gemma = apply_lora
