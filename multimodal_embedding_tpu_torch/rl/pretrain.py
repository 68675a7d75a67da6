"""Supervised format pretraining for the offline RL stand-in base.

Counterpart of ``multimodal_embedding_tpu/rl/pretrain.py`` (``format_pairs``
:27, ``supervised_pretrain`` :53). The reference's GRPO starts from a
PRETRAINED Qwen3-14B that can already emit JSON (train_rl_pure_lora.py:
74-82); a random-init toy decoder cannot, and sequence-level GRPO alone
cannot cross the exploration chasm to an exact 20-byte JSON string. This
module builds the equivalent starting point offline: brief teacher-forcing
on (prompt -> JSON completion) pairs whose field VALUES are seed-random, so
the base learns the output format but carries no task knowledge.

The batches are the JAX function's (the same ``default_rng(seed)`` draws);
the optimizer is ``torch.optim.Adam`` with optax ``adam``'s numbers, over
every parameter of the module, trained in place.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import tokenizer as tok
from .grpo import _completion_logps
from ..models.decoder import DecoderLM

logger = logging.getLogger("mme_tpu")

# optax.adam(lr)'s other numbers (JAX rl/pretrain.py:83): no weight decay
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


def format_pairs(
    dataset: list[dict], field: str, choices: list[str], seed: int = 0,
    balanced: bool = False,
) -> list[tuple[str, str]]:
    """(prompt, completion) pairs with uniformly random field values: format
    supervision only — expected accuracy of the pretrained base is chance.

    balanced=True pairs EVERY prompt with EVERY choice (|dataset|x|choices|
    pairs). The CE optimum is then a deterministic JSON scaffold with a
    uniform field value per prompt, so long pretraining drives the parse
    rate toward 1.0 WITHOUT collapsing within-group sampling diversity —
    the starting point GRPO needs (random-value pairing memorizes one
    value per prompt at convergence, killing the group advantage signal)."""
    if balanced:
        return [
            (r["prompt"], f'{{"{field}": "{c}"}}')
            for r in dataset
            for c in choices
        ]
    rng = np.random.default_rng(seed)
    return [
        (r["prompt"], f'{{"{field}": "{choices[int(rng.integers(len(choices)))]}"}}')
        for r in dataset
    ]


def supervised_pretrain(
    model: DecoderLM,
    pairs: list[tuple[str, str]],
    steps: int,
    tokenizer=None,
    batch_size: int = 8,
    learning_rate: float = 3e-4,
    max_prompt_len: int = 256,
    max_completion_len: int = 32,
    seed: int = 0,
    log_every: int = 50,
):
    """Teacher-forcing CE on completion tokens (+EOS), every parameter of
    ``model`` trained in place (switched to ``requires_grad`` for the run and
    back after). Returns (model, per-step losses)."""
    tk = tokenizer or tok.ByteTokenizer()
    p_ids_all, p_mask_all = tk.pad_left(
        [tk.encode(p, max_prompt_len) for p, _ in pairs], max_len=max_prompt_len
    )
    tn = max_completion_len
    c_ids_all = np.full((len(pairs), tn), tk.pad_id, np.int32)
    c_mask_all = np.zeros((len(pairs), tn), np.float32)
    for i, (_, comp) in enumerate(pairs):
        ids = list(tk.encode(comp, tn - 1)) + [tk.eos_id]
        c_ids_all[i, : len(ids)] = ids
        c_mask_all[i, : len(ids)] = 1.0

    params = list(model.parameters())
    trainable = [p.requires_grad for p in params]
    opt = torch.optim.Adam(params, lr=learning_rate, **ADAM)
    dev = model.device
    rng = np.random.default_rng(seed)
    losses = []
    try:
        for p in params:
            p.requires_grad_(True)
        for s in range(steps):
            sel = rng.integers(0, len(pairs), size=batch_size)
            p_ids, p_mask, c_ids, c_mask = (
                torch.from_numpy(a[sel]).to(dev) for a in (p_ids_all, p_mask_all, c_ids_all, c_mask_all)
            )
            # pad targets keep attention but are loss-masked
            nll = -_completion_logps(model, p_ids, p_mask, c_ids)
            loss = torch.sum(nll * c_mask) / torch.clamp(torch.sum(c_mask), min=1.0)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if s % log_every == 0:
                logger.info(f"pretrain step {s}: CE {losses[-1]:.4f}")
    finally:
        for p, flag in zip(params, trainable):
            p.requires_grad_(flag)
            p.grad = None
    return model, losses
