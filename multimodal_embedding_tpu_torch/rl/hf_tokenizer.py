"""HF tokenizer + chat template for the RL pipeline.

The reference tokenizes with the Qwen3 HF tokenizer and formats prompts with
``apply_chat_template`` (train_rl_pure_lora.py:74-76 + prepare_data.py,
verify_rl.py:34-44: system + user messages, ``add_generation_prompt=True``).
This wrapper exposes that under the same protocol as rl/tokenizer.ByteTokenizer
so the GRPO/verify stack is tokenizer-agnostic; it is used when a local
tokenizer directory or cached HF id is available (no network egress here —
``local_files_only`` unless the files are already on disk).
"""

from __future__ import annotations

import numpy as np


class HFTokenizer:
    name = "hf"

    def __init__(self, name_or_path: str, local_files_only: bool = True):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            name_or_path, trust_remote_code=True, local_files_only=local_files_only
        )
        # reference: tokenizer.pad_token = tokenizer.eos_token
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.eos_token
        self.pad_id = int(self._tok.pad_token_id)
        self.eos_id = int(self._tok.eos_token_id)
        self.vocab_size = int(len(self._tok))

    def encode(self, text: str, max_len: int | None = None) -> np.ndarray:
        ids = self._tok.encode(text, add_special_tokens=False)
        if max_len is not None:
            ids = ids[-max_len:]
        return np.asarray(ids, np.int32)

    def decode_until_eos(self, ids) -> str:
        out = []
        for i in ids:
            if int(i) == self.eos_id:
                break
            out.append(int(i))
        return self._tok.decode(out, skip_special_tokens=True)

    def pad_left(self, batch: list[np.ndarray], max_len: int | None = None):
        t = max_len or max(len(x) for x in batch)
        ids = np.full((len(batch), t), self.pad_id, np.int32)
        mask = np.zeros((len(batch), t), np.int32)
        for i, x in enumerate(batch):
            x = x[-t:]
            ids[i, t - len(x):] = x
            mask[i, t - len(x):] = 1
        return ids, mask

    def format_prompt(self, prompt: str, system: str | None = None) -> str:
        """Qwen chat template with generation prompt (verify_rl.py:34-44)."""
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
