"""CLI: GRPO/LoRA RL fine-tuning (Workload B) on one NVIDIA GPU.

Counterpart of ``multimodal_embedding_tpu/cli/train_rl.py``: the reference
entry points ``train_rl_pure_lora.py`` (support tickets) and
``train_rl_hard.py`` (fintech) as ``--task support`` / ``--task fintech``,
with the reference's hyperparameters as defaults (lr 1e-5, 8 generations,
grad-accum 4, 5 epochs). The same flags plus ``--device {cuda,cpu}``
(default cuda; without a CUDA device it exits nonzero unless ``--device
cpu`` was given). ``--format-pretrain N`` teacher-forces the base first
(``rl/pretrain.py``), ``--save-base`` writes it as a native ``.npz`` either
package's ``load_params`` reads, and the run writes
``<output-dir>/lora_adapters.npz`` (``<target>.a`` / ``<target>.b``) and
``training_stats.npz`` in the JAX CLI's layout. ``build_model`` (shared with
``cli/verify_rl.py``) builds the base on the device: a ``--base-params``
checkpoint in its dtype, else a random f32 init at ``--model-size``.

    python -m multimodal_embedding_tpu_torch.cli.train_rl --arch qwen3 \\
        --model-size small --format-pretrain 200 --save-base rl_result/base.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from ..models.gemma import GemmaConfig
from ..models.qwen3 import QWEN3_14B, Qwen3Config
from ..rl import tokenizer as tok
from ..rl.datasets import generate_fintech_dataset, generate_support_tickets
from ..rl.grpo import GRPOConfig, GRPOTrainer
from ..rl.lora import LoraConfig
from ..rl.policy import get_arch
from ..rl.rewards import fintech_reward, support_ticket_reward
from ..utils.logging import setup_logging
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GRPO + LoRA RL trainer (NVIDIA GPU)")
    p.add_argument("--task", choices=["support", "fintech"], default="support")
    p.add_argument("--arch", choices=["gemma", "qwen3"], default="gemma",
                   help="policy architecture (qwen3 = the reference's base model family)")
    p.add_argument("--model-size", choices=["debug", "small", "full"], default="small")
    p.add_argument("--base-params", type=str, default=None,
                   help="native .npz checkpoint of converted base weights")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="HF tokenizer dir/id (local) -> chat-template prompts; default byte-level")
    p.add_argument("--system-prompt", type=str, default=None)
    p.add_argument("--dataset-size", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--num-generations", type=int, default=8)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="rollout sampling temperature")
    p.add_argument("--kl-beta", type=float, default=0.04,
                   help="KL penalty weight toward the frozen base "
                        "(reference default 0.04)")
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--lora-alpha", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", type=str, default="rl_result")
    p.add_argument("--format-pretrain", type=int, default=0,
                   help="supervised format-pretraining steps on the base "
                        "before GRPO (random field values — the offline "
                        "equivalent of the reference's pretrained Qwen3 base "
                        "that can already emit JSON)")
    p.add_argument("--save-base", type=str, default=None,
                   help="persist the (possibly pretrained) base params as a "
                        "native .npz for verify_rl --base-params")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on (cuda unless --device cpu is given)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("train_rl.log")

    base, mcfg, arch, tokenizer, system_prompt = build_model(args)

    if args.task == "support":
        dataset = generate_support_tickets(args.dataset_size, seed=args.seed)
        reward = support_ticket_reward
        field, choices = "category", ["BILLING", "TECHNICAL", "SHIPPING", "OTHER"]
    else:
        dataset = generate_fintech_dataset(args.dataset_size, seed=args.seed)
        reward = fintech_reward
        field, choices = "decision", [
            "STANDARD_LOAN", "MANUAL_REVIEW", "REJECT_RISK", "A_PLUS_TIER",
        ]

    if args.format_pretrain:
        from ..rl.pretrain import format_pairs, supervised_pretrain

        pairs = format_pairs(dataset, field, choices, seed=args.seed)
        logger.info(f"Format pretraining: {args.format_pretrain} steps on {len(pairs)} pairs")
        base, pre_losses = supervised_pretrain(
            base, pairs, args.format_pretrain, tokenizer=tokenizer, seed=args.seed,
        )
        logger.info(
            f"Pretrain CE: {pre_losses[0]:.3f} -> {np.mean(pre_losses[-20:]):.3f}"
        )

    if args.save_base:
        from ..models.checkpoint import save_params
        from ..models.params import params_to_jax

        save_params(args.save_base, params_to_jax(base), mcfg)
        logger.info(f"Saved base params to {args.save_base}")

    cfg = GRPOConfig(
        learning_rate=args.learning_rate,
        group_size=args.num_generations,
        epochs=args.epochs,
        grad_accum=args.grad_accum,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        kl_beta=args.kl_beta,
        lora=LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha),
        seed=args.seed,
    )
    trainer = GRPOTrainer(base, reward, cfg, tokenizer=tokenizer, system_prompt=system_prompt)
    logger.info(
        f"GRPO training: task={args.task}, arch={arch.name}, "
        f"tokenizer={tokenizer.name}, {len(dataset)} prompts, {cfg}"
    )
    stats = trainer.train(dataset)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    flat = {}
    for name, ab in trainer.adapters.items():
        flat[f"{name}.a"] = ab["a"].detach().cpu().numpy()
        flat[f"{name}.b"] = ab["b"].detach().cpu().numpy()
    np.savez(out / "lora_adapters.npz", **flat)
    np.savez(out / "training_stats.npz", **{k: np.asarray(v) for k, v in stats.items()})
    logger.info(
        f"Saved adapters to {out}/lora_adapters.npz — "
        f"final mean reward {np.mean(stats['mean_reward'][-8:]):.2f} "
        f"(first window {np.mean(stats['mean_reward'][:8]):.2f})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
