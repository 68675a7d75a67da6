"""RL verification harness: greedy generation over a dataset, then the
reference's three rates.

Counterpart of ``multimodal_embedding_tpu/rl/verify.py``
(``extract_json_field`` :29, ``evaluate`` :43, ``evaluate_merged`` :95).
Merges the LoRA adapters into the base weights (``merge_and_unload``),
generates greedily in batches of ``batch_size`` (the last batch padded with
its last prompt, prompts left-padded to ``max_prompt_len``) and scores the
no-<think> rate, the clean-JSON rate and the accuracy against the records'
answers. The byte tokenizer offline, or any tokenizer of the same protocol
(``rl/hf_tokenizer.py``).
"""

from __future__ import annotations

import json
import re

import torch

from . import tokenizer as tok
from .generate import generate
from .lora import LoraConfig, lora_merge
from ..models.decoder import DecoderLM


def extract_json_field(text: str, field: str) -> str | None:
    """Strict JSON first, then a regex fallback."""
    s = text.strip()
    try:
        return json.loads(s).get(field)
    except (json.JSONDecodeError, AttributeError):
        pass
    m = re.search(rf'"{field}"\s*:\s*"([A-Z_+]+)"', s)
    return m.group(1) if m else None


def evaluate(
    model: DecoderLM,
    dataset: list[dict],
    answer_field: str,
    max_new: int = 48,
    batch_size: int = 8,
    max_prompt_len: int = 256,
    tokenizer=None,
    system_prompt: str | None = None,
) -> dict:
    """Greedy generation + scoring. dataset: [{'prompt', 'answer'}]."""
    tk = tokenizer or tok.ByteTokenizer()
    n = len(dataset)
    texts: list[str] = []
    for s in range(0, n, batch_size):
        batch = dataset[s : s + batch_size]
        ids = [tk.encode(tk.format_prompt(r["prompt"], system_prompt), max_prompt_len) for r in batch]
        ids += [ids[-1]] * (batch_size - len(batch))
        p_ids, p_mask = tk.pad_left(ids, max_len=max_prompt_len)
        comps, _ = generate(model, torch.from_numpy(p_ids).to(model.device),
                            torch.from_numpy(p_mask).to(model.device), max_new, greedy=True)
        texts.extend(tk.decode_until_eos(c) for c in comps[: len(batch)].cpu().numpy())

    no_think = sum("<think>" not in t for t in texts)
    clean_json = 0
    correct = 0
    for rec, t in zip(dataset, texts):
        try:
            json.loads(t.strip())
            clean_json += 1
        except json.JSONDecodeError:
            pass
        if extract_json_field(t, answer_field) == rec["answer"]:
            correct += 1
    return {
        "no_think_rate": 100.0 * no_think / n,
        "clean_json_rate": 100.0 * clean_json / n,
        "accuracy": 100.0 * correct / n,
        "n": n,
    }


def evaluate_merged(base: DecoderLM, adapters: dict, lora_cfg: LoraConfig, dataset: list[dict],
                    answer_field: str, **kw) -> dict:
    return evaluate(lora_merge(base, adapters, lora_cfg), dataset, answer_field, **kw)
