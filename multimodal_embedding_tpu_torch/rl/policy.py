"""Decoder-architecture registry for the RL stack.

Counterpart of ``multimodal_embedding_tpu/rl/policy.py``. The JAX package
bundles each decoder's functions (embed, apply, lm_logits, prefill,
decode_step, init) in a ``DecoderArch``; in the port they are the methods of
the decoder's module (``models/decoder.py:DecoderLM``), so an arch names the
module and its config type and builds the module: from a seeded generator
(``init``) or from a JAX-layout param tree (``from_params``). Gemma is the
offline stand-in; Qwen3 is the reference's base model family
(Qwen/Qwen3-14B).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from ..models.decoder import DecoderLM
from ..models.gemma import Gemma, GemmaConfig
from ..models.params import load_tree
from ..models.qwen3 import Qwen3, Qwen3Config
from ..models.towers import seeded_generator


@dataclass(frozen=True)
class DecoderArch:
    name: str
    config: type
    module: type  # (cfg, *, gen, device, dtype) -> DecoderLM

    def init(self, cfg, *, seed: int, device, dtype=torch.float32) -> DecoderLM:
        """Random weights drawn from ``torch.Generator(seed)`` on ``device``."""
        return self.module(cfg, gen=seeded_generator(seed, device), device=device, dtype=dtype)

    def from_params(self, tree: Mapping[str, Any], cfg, *, device, dtype=torch.float32) -> DecoderLM:
        """The module holding a JAX-layout param tree's weights in ``dtype``
        (built on ``meta``: the tree's tensors are the only copy on ``device``)."""
        return load_tree(self.module(cfg, gen=None, device="meta", dtype=dtype), tree, dtype, device=device)


GEMMA = DecoderArch(name="gemma", config=GemmaConfig, module=Gemma)
QWEN3 = DecoderArch(name="qwen3", config=Qwen3Config, module=Qwen3)

ARCHS = {"gemma": GEMMA, "qwen3": QWEN3}


def get_arch(name: str) -> DecoderArch:
    return ARCHS[name]
