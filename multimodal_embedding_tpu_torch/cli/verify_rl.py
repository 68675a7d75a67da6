"""CLI: RL verification on one NVIDIA GPU (reference verify_rl.py /
verify_rl_debug.py).

Counterpart of ``multimodal_embedding_tpu/cli/verify_rl.py``, with the same
flags plus ``--device {cuda,cpu}`` (default cuda; without a CUDA device it
exits nonzero unless ``--device cpu`` was given). Loads the LoRA adapters
(``--adapters``, an ``.npz`` of ``<target>.a`` / ``<target>.b``), merges them
into the base policy, greedily generates over the dataset and prints the
no-<think> rate, clean-JSON rate and accuracy, optionally after the untrained
baseline's (``--baseline``). The base is a ``--base-params`` checkpoint in its
own dtype, or a random f32 init at ``--model-size``.

    python -m multimodal_embedding_tpu_torch.cli.verify_rl --arch qwen3 \\
        --model-size small --adapters rl_result/lora_adapters.npz --baseline
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..rl.datasets import generate_fintech_dataset, generate_support_tickets
from ..rl.lora import LoraConfig
from ..rl.verify import evaluate, evaluate_merged
from ..utils.logging import setup_logging
from .train_rl import build_model

logger = logging.getLogger("mme_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Verify GRPO/LoRA results")
    p.add_argument("--task", choices=["support", "fintech"], default="support")
    p.add_argument("--arch", choices=["gemma", "qwen3"], default="gemma")
    p.add_argument("--model-size", choices=["debug", "small", "full"], default="small")
    p.add_argument("--base-params", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--system-prompt", type=str, default=None)
    p.add_argument("--adapters", type=str, default="rl_result/lora_adapters.npz")
    p.add_argument("--dataset-size", type=int, default=50)
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--lora-alpha", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--baseline", action="store_true", help="Also evaluate the untrained base")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on (cuda unless --device cpu is given)")
    return p.parse_args(argv)


def load_adapters(path: str) -> dict:
    """``<target>.a`` / ``<target>.b`` arrays -> {target: {"a", "b"}}."""
    adapters: dict = {}
    with np.load(path) as data:
        for key in data.files:
            name, part = key.split(".")
            adapters.setdefault(name, {})[part] = data[key]
    return adapters


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("verify_rl.log")

    base, mcfg, arch, tokenizer, system_prompt = build_model(args)

    if args.task == "support":
        dataset = generate_support_tickets(args.dataset_size, seed=args.seed + 1)
        field = "category"
    else:
        dataset = generate_fintech_dataset(args.dataset_size, seed=args.seed + 1)
        field = "decision"

    kw = dict(tokenizer=tokenizer, system_prompt=system_prompt)
    if args.baseline:
        stats = evaluate(base, dataset, field, **kw)
        logger.info(f"BASELINE: {stats}")

    lcfg = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    stats = evaluate_merged(base, load_adapters(args.adapters), lcfg, dataset, field, **kw)
    logger.info(f"TRAINED: {stats}")
    print(stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
