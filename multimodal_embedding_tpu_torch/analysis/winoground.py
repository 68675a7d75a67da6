"""Winoground compositional-reasoning evaluator (reference v28:413-461).

Counterpart of ``multimodal_embedding_tpu/analysis/winoground.py``. Each
example has two images and two captions with the same words in a different
order; the 2x2 score matrix s[c, i] (rows = captions, cols = images, the
reference's ``te @ ie.T`` orientation) gives

    text  = s[0,0] > s[0,1] and s[1,1] > s[1,0]
    image = s[0,0] > s[1,0] and s[1,1] > s[0,1]
    group = text and image

All 2N images and 2N captions are encoded in batches; dense scores are one
f32 matmul, multi-vector scores the MaxSim kernel (``retrieval/scoring.py``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.encode import EncodingEngine
from ..retrieval.scoring import late_interaction_scores

logger = logging.getLogger("mme_tpu")


def load_winoground(sample_size: int | None = None, synthetic: bool = False, seed: int = 42):
    """Records: {'image_0','image_1': uint8 HWC, 'caption_0','caption_1': str}.

    facebook/winoground is a gated HF dataset: the token comes from HF_TOKEN
    / HUGGING_FACE_HUB_TOKEN, and an unauthenticated or offline load is
    logged and skipped (an empty list: run_winoground returns {} and the row
    has no Wino columns)."""
    if synthetic:
        from ..data.synthetic import synthetic_retrieval_dataset

        base = synthetic_retrieval_dataset((sample_size or 40) * 2, seed=seed)
        return [
            {
                "image_0": base[2 * i]["image"],
                "image_1": base[2 * i + 1]["image"],
                "caption_0": base[2 * i]["captions"][0],
                "caption_1": base[2 * i + 1]["captions"][0],
            }
            for i in range(sample_size or 40)
        ]
    import os

    from datasets import load_dataset

    token = os.environ.get("HF_TOKEN") or os.environ.get("HUGGING_FACE_HUB_TOKEN")
    try:
        ds = load_dataset("facebook/winoground", split="test", token=token)
    except Exception as e:  # gated or offline: skip the dataset, keep the benchmark
        logger.warning("Winoground unavailable (gated dataset — set HF_TOKEN to authenticate); skipping: %s", e)
        return []
    if sample_size is not None and sample_size < len(ds):
        ds = ds.select(range(sample_size))
    return [
        {
            "image_0": np.asarray(ex["image_0"].convert("RGB")),
            "image_1": np.asarray(ex["image_1"].convert("RGB")),
            "caption_0": ex["caption_0"],
            "caption_1": ex["caption_1"],
        }
        for ex in ds
    ]


def run_winoground(engine: EncodingEngine, records: list[dict]) -> dict[str, float]:
    """Returns {'Wino Text','Wino Image','Wino Group'} percentages."""
    n = len(records)
    if n == 0:
        return {}
    images = [r["image_0"] for r in records] + [r["image_1"] for r in records]
    texts = [r["caption_0"] for r in records] + [r["caption_1"] for r in records]

    ie = engine.encode_images(images).embeddings  # [2N, ...]
    te = engine.encode_texts(texts).embeddings
    if engine.model.multi_vector:
        s = late_interaction_scores(te, ie)  # [2N caps, 2N imgs]
    else:
        s = torch.matmul(te.float(), ie.float().T)
    s = s.cpu().numpy()

    idx = np.arange(n)
    s00 = s[idx, idx]  # cap0 . img0
    s01 = s[idx, idx + n]  # cap0 . img1
    s10 = s[idx + n, idx]  # cap1 . img0
    s11 = s[idx + n, idx + n]  # cap1 . img1

    text_ok = (s00 > s01) & (s11 > s10)
    image_ok = (s00 > s10) & (s11 > s01)
    group_ok = text_ok & image_ok
    return {
        "Wino Text": 100.0 * float(text_ok.mean()),
        "Wino Image": 100.0 * float(image_ok.mean()),
        "Wino Group": 100.0 * float(group_ok.mean()),
    }
