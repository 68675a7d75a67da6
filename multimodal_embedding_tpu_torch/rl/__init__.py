"""Workload B: GRPO/LoRA RL fine-tuning and its verification on one NVIDIA
GPU.

Counterpart of ``multimodal_embedding_tpu/rl``: the decoder registry
(``policy.py``), LoRA adapters with their merge and their differentiable
view (``lora.py``), KV-cache generation (``generate.py``), the GRPO trainer
(``grpo.py``), the supervised format pretrain (``pretrain.py``), the
verification harness (``verify.py``), and copies of the JAX-free reward
functions, dataset generators and tokenizers.
"""

from .lora import lora_init, lora_merge, apply_lora, apply_lora_to_gemma
from .policy import GEMMA, QWEN3, DecoderArch, get_arch
from .rewards import support_ticket_reward, fintech_reward
from .datasets import generate_fintech_dataset, generate_support_tickets

__all__ = [
    "lora_init",
    "lora_merge",
    "apply_lora",
    "apply_lora_to_gemma",
    "GEMMA",
    "QWEN3",
    "DecoderArch",
    "get_arch",
    "support_ticket_reward",
    "fintech_reward",
    "generate_fintech_dataset",
    "generate_support_tickets",
]
