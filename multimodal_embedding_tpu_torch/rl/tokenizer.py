"""Reversible byte-level tokenizer for the offline RL pipeline.

The reference tokenizes with Qwen's HF tokenizer (train_rl_pure_lora.py:76);
offline we need a tokenizer that can both encode prompts and DECODE sampled
ids back to text for the JSON-reward judges. Byte-level is lossless and needs
no vocab files: id = byte + 3, with pad=0, bos=1, eos=2.
"""

from __future__ import annotations

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
VOCAB_SIZE = 259


def encode(text: str, max_len: int | None = None, add_bos: bool = True) -> np.ndarray:
    ids = [BOS_ID] if add_bos else []
    ids += [b + 3 for b in text.encode("utf-8")]
    if max_len is not None:
        ids = ids[-max_len:]
    return np.asarray(ids, np.int32)


def decode(ids) -> str:
    # ids outside the byte range (possible when the LM head has extra vocab
    # slots) are skipped
    by = bytes(int(i) - 3 for i in ids if 3 <= int(i) < VOCAB_SIZE)
    return by.decode("utf-8", errors="replace")


def decode_until_eos(ids) -> str:
    out = []
    for i in ids:
        if int(i) == EOS_ID:
            break
        out.append(int(i))
    return decode(out)


def pad_left(batch: list[np.ndarray], max_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad a batch of id arrays -> (ids [B, T], mask [B, T])."""
    t = max_len or max(len(x) for x in batch)
    ids = np.full((len(batch), t), PAD_ID, np.int32)
    mask = np.zeros((len(batch), t), np.int32)
    for i, x in enumerate(batch):
        x = x[-t:]
        ids[i, t - len(x):] = x
        mask[i, t - len(x):] = 1
    return ids, mask


class ByteTokenizer:
    """Object facade over the module functions — the tokenizer protocol the
    RL stack consumes (rl/hf_tokenizer.HFTokenizer is the other impl):
    encode / decode_until_eos / pad_left / format_prompt + pad/eos/vocab ids.
    """

    pad_id = PAD_ID
    eos_id = EOS_ID
    vocab_size = VOCAB_SIZE
    name = "byte"

    def encode(self, text: str, max_len: int | None = None) -> np.ndarray:
        return encode(text, max_len)

    def decode_until_eos(self, ids) -> str:
        return decode_until_eos(ids)

    def pad_left(self, batch, max_len=None):
        return pad_left(batch, max_len)

    def format_prompt(self, prompt: str, system: str | None = None) -> str:
        """No chat template: dataset prompts already carry their system line
        (rl/datasets.py); an explicit system is prepended plainly."""
        return f"{system}\n\n{prompt}" if system else prompt
