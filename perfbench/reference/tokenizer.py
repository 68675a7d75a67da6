"""The word tokenizer of the random-weight models, a frozen copy: BOS 1,
one id a lower-cased word (``2 + hash(word) % (vocab - 3)``), EOS, zeros
after, at most ``max_len`` tokens. The EOS id is ``min(49407, vocab - 1)``,
the largest id, so CLIP's legacy pooling at the largest id finds it.

Python's ``hash`` of a string is salted per process unless
``PYTHONHASHSEED`` is set (``perfbench/run.py`` pins it), so these ids equal
the port's within one process.
"""

from __future__ import annotations

import torch


def tokenize(texts: list[str], vocab_size: int, max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, mask), int64 [len(texts), max_len] each, on the CPU."""
    eos = min(49407, vocab_size - 1)
    ids = torch.zeros(len(texts), max_len, dtype=torch.int64)
    mask = torch.zeros(len(texts), max_len, dtype=torch.int64)
    for i, t in enumerate(texts):
        toks = [1] + [2 + hash(w) % (vocab_size - 3) for w in t.lower().split()[: max_len - 2]] + [eos]
        ids[i, : len(toks)] = torch.tensor(toks)
        mask[i, : len(toks)] = 1
    return ids, mask
