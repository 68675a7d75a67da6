"""ColPali processor semantics, implemented natively.

A copy of ``multimodal_embedding_tpu/models/colpali_processing.py`` (numpy
only). The reference encodes queries via ``processor.process_queries`` and
images via ``processor.process_images`` (reference main.py:397-404), which
wrap the raw text/image in the ColPali prompt scheme. This module reproduces
that wrapping so the framework owns the token-stream contract instead of
delegating to the HF processor black box:

- queries:  ``<bos> + query_prefix + text + <pad>*10 + "\\n"`` tokenized with
  no added specials and batch-padded to the longest sequence. No truncation:
  ColPaliProcessor passes max_length=50 but never activates truncation, so
  the ids are unbounded (verified against transformers 4.57). The ten
  trailing pad tokens are *query augmentation buffer* tokens — they are
  genuine prompt content and carry attention mask 1 (only batch padding
  gets 0).
- images:   ``<image> * image_seq_length`` then the textual suffix
  ``<bos> + visual_prompt_prefix + "\\n"``. The image-token block is implicit
  in the forward (``ColPali.image_fwd`` concatenates projected patch features
  with the embedded suffix), so only the suffix ids are materialized.

Parity with ``transformers.ColPaliProcessor`` is held token for token in
tests/test_torch_colpali_loading.py with an offline-built Gemma tokenizer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ColPaliPrompts:
    """Prompt scheme constants, read from the checkpoint's processor config
    at load time (vidore/colpali-v1.3 ships query_prefix='Query: ')."""

    query_prefix: str = "Query: "
    visual_prompt_prefix: str = "Describe the image."
    n_augmentation_tokens: int = 10


def process_queries_ids(
    tokenizer, texts: list[str], prompts: ColPaliPrompts = ColPaliPrompts()
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize queries exactly like ``ColPaliProcessor.process_queries``.

    Returns (input_ids, attention_mask) as int32 arrays. The augmentation
    buffer (pad_token * 10) is attended; the trailing newline mirrors the
    PaliGemma prompt convention. Deliberately no truncation — the HF
    processor's nominal max_length=50 is inert (tokenizer truncation is
    never activated by padding='longest' alone).
    """
    suffix = tokenizer.pad_token * prompts.n_augmentation_tokens
    strings = [
        tokenizer.bos_token + prompts.query_prefix + t + suffix + "\n" for t in texts
    ]
    out = tokenizer(
        strings,
        add_special_tokens=False,
        padding="longest",
        return_tensors="np",
    )
    return (
        out["input_ids"].astype(np.int32),
        out["attention_mask"].astype(np.int32),
    )


def image_prompt_suffix_ids(
    tokenizer, prompts: ColPaliPrompts = ColPaliPrompts()
) -> np.ndarray:
    """Token ids of the text that follows the image-token block:
    ``<bos>Describe the image.\\n`` (ColPaliProcessor build_string_from_input)."""
    s = tokenizer.bos_token + prompts.visual_prompt_prefix + "\n"
    ids = tokenizer(s, add_special_tokens=False, return_tensors="np")["input_ids"]
    return ids[0].astype(np.int32)


def image_input_ids(
    tokenizer,
    image_token_id: int,
    image_seq_length: int,
    n_images: int,
    prompts: ColPaliPrompts = ColPaliPrompts(),
) -> np.ndarray:
    """Full per-image input_ids as the HF processor would emit them —
    ``<image>*seq + <bos> + prompt + \\n`` — used for parity testing against
    ``ColPaliProcessor.process_images`` and for driving HF reference models."""
    suffix = image_prompt_suffix_ids(tokenizer, prompts)
    row = np.concatenate(
        [np.full((image_seq_length,), image_token_id, np.int32), suffix]
    )
    return np.tile(row, (n_images, 1))


def prompts_from_processor(proc) -> ColPaliPrompts:
    """Read the prompt scheme from a loaded HF ColPaliProcessor so checkpoint
    overrides (query_prefix etc.) are honored."""
    return ColPaliPrompts(
        query_prefix=getattr(proc, "query_prefix", "Query: "),
        visual_prompt_prefix=getattr(proc, "visual_prompt_prefix", "Describe the image."),
    )


def colpali_query_tokenizer(tokenizer, prompts: ColPaliPrompts = ColPaliPrompts()):
    """Tokenize callable for LoadedModel: texts -> (ids, mask)."""

    def tokenize(texts: list[str]):
        return process_queries_ids(tokenizer, texts, prompts)

    return tokenize
