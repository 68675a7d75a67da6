"""CLI: GRPO/LoRA RL fine-tuning (Workload B), of which the port has the
model building so far.

Counterpart of ``multimodal_embedding_tpu/cli/train_rl.py``, so far the part
``cli/verify_rl.py`` imports: ``REFERENCE_SYSTEM_PROMPT``,
``default_gemma_config``, ``default_qwen3_config`` and ``build_model`` (which
reads the verify CLI's flags, ``--device`` among them). Its ``main`` raises
"GRPO training is not yet ported" (ROADMAP.md, slice 11).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..models.gemma import GemmaConfig
from ..models.qwen3 import QWEN3_14B, Qwen3Config
from ..rl import tokenizer as tok
from ..rl.policy import get_arch
from .main import resolve_device

logger = logging.getLogger("mme_tpu")

# The reference's system prompt (train_rl_pure_lora.py:89 / prepare_data.py),
# applied when the HF chat template is active.
REFERENCE_SYSTEM_PROMPT = (
    "You are a strict data extraction engine.\n"
    "RULES:\n"
    "1. Output ONLY a JSON object.\n"
    "2. DO NOT use <think> tags.\n"
    '3. Allowed categories: ["BILLING", "TECHNICAL", "SHIPPING", "PRODUCT", "OTHER"].'
)

# a native checkpoint's leaf dtype -> the dtype its model runs in
_TREE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def default_gemma_config(size: str) -> GemmaConfig:
    if size == "debug":
        return GemmaConfig(
            vocab_size=tok.VOCAB_SIZE, dim=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, mlp_dim=128,
        )
    if size == "small":
        return GemmaConfig(
            vocab_size=tok.VOCAB_SIZE, dim=512, layers=8, heads=8, kv_heads=1,
            head_dim=64, mlp_dim=2048,
        )
    raise ValueError(size)


def default_qwen3_config(size: str, vocab_size: int | None = None) -> Qwen3Config:
    """Qwen3 geometry at reduced scale for offline runs; 'full' is the true
    Qwen/Qwen3-14B config (for checkpoint loads)."""
    v = vocab_size or tok.VOCAB_SIZE
    if size == "debug":
        return Qwen3Config(
            vocab_size=v, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16,
            mlp_dim=128, tie_embeddings=True,
        )
    if size == "small":
        return Qwen3Config(
            vocab_size=v, dim=512, layers=8, heads=8, kv_heads=4, head_dim=64,
            mlp_dim=2048, tie_embeddings=True,
        )
    if size == "full":
        return QWEN3_14B
    raise ValueError(size)


def _tree_dtype(tree) -> torch.dtype:
    """The dtype of a param tree's floating leaves (the JAX CLI runs a loaded
    checkpoint in its own dtype)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return _TREE_DTYPES[np.asarray(tree).dtype.name]


def build_model(args):
    """(base model, model_cfg, arch, tokenizer, system_prompt) per CLI args,
    on ``args.device``: a ``--base-params`` checkpoint in its dtype, else a
    random f32 init at ``--model-size`` drawn from ``--seed``."""
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    tokenizer = tok.ByteTokenizer()
    system_prompt = args.system_prompt
    if args.tokenizer:
        from ..rl.hf_tokenizer import HFTokenizer

        tokenizer = HFTokenizer(args.tokenizer)
        if system_prompt is None:
            system_prompt = REFERENCE_SYSTEM_PROMPT

    if args.base_params:
        from ..models.checkpoint import load_params

        tree, mcfg = load_params(args.base_params)
        if not isinstance(mcfg, arch.config):
            raise SystemExit(
                f"--base-params checkpoint is a {type(mcfg).__name__} but "
                f"--arch {args.arch} expects {arch.config.__name__}; pass the "
                f"matching --arch for this checkpoint"
            )
        base = arch.from_params(tree, mcfg, device=device, dtype=_tree_dtype(tree))
        logger.info(f"Loaded base params from {args.base_params}: {mcfg}")
    else:
        if args.arch == "qwen3":
            mcfg = default_qwen3_config(args.model_size, tokenizer.vocab_size)
        else:
            if args.model_size == "full":
                raise SystemExit("--model-size full requires --arch qwen3")
            mcfg = default_gemma_config(args.model_size)
            if tokenizer.vocab_size != mcfg.vocab_size:
                mcfg = dataclasses.replace(mcfg, vocab_size=tokenizer.vocab_size)
        base = arch.init(mcfg, seed=args.seed, device=device)
    return base, mcfg, arch, tokenizer, system_prompt


def main(argv=None) -> int:
    raise NotImplementedError("GRPO training is not yet ported to the PyTorch/CUDA package (ROADMAP.md)")


if __name__ == "__main__":
    raise SystemExit(main())
