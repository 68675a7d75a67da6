"""Benchmark dataset pipeline (reference main.py:754-787).

Dataset flow for COCO-Karpathy: HF load → prefilter >=5 captions → threaded
image caching with verification → refilter loadable → assert >=4900 → optional
deterministic shuffle+sample. Flickr30k (the v15-era adapter, SURVEY.md §7.4)
and the offline synthetic dataset share the same record schema:
``{'image': np.uint8 HWC, 'captions': list[str], 'imgid': ...}``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .captions import get_all_captions
from .download import load_cached_image, prepare_dataset_cache
from .synthetic import synthetic_retrieval_dataset

logger = logging.getLogger("mme_tpu")

MIN_COCO_SIZE = 4900
SEED = 42


def _load_coco(cache_dir: Path, workers: int, sample_size: int, seed: int) -> list[dict]:
    from datasets import load_dataset

    logger.info("LOADING COCO-KARPATHY TEST SET...")
    ds = load_dataset("yerevann/coco-karpathy", split="test", num_proc=1)
    logger.info(f"Raw Dataset Size: {len(ds)}")

    valid = [i for i, item in enumerate(ds) if len(get_all_captions(item, "sentences")) >= 5]
    ds = ds.select(valid)

    prepare_dataset_cache(ds, cache_dir, workers=workers)

    loadable = [i for i, item in enumerate(ds) if load_cached_image(item, cache_dir) is not None]
    ds = ds.select(loadable)
    logger.info(f"Final Dataset Size: {len(ds)}")
    if len(ds) < MIN_COCO_SIZE:
        logger.error("Dataset too small!")
        raise SystemExit(1)

    if sample_size < len(ds):
        ds = ds.shuffle(seed=seed).select(range(sample_size))

    records = []
    for item in ds:
        img = load_cached_image(item, cache_dir)
        if img is None:
            continue
        records.append(
            {
                "image": np.asarray(img),
                "captions": get_all_captions(item, "sentences")[:5],
                "imgid": item["imgid"],
            }
        )
    return records


def _load_flickr30k(sample_size: int, seed: int) -> list[dict]:
    """Flickr30k test split (nlphuji/flickr30k carries images inline)."""
    from datasets import load_dataset

    ds = load_dataset("nlphuji/flickr30k", split="test")
    ds = ds.filter(lambda x: x["split"] == "test")
    if sample_size < len(ds):
        ds = ds.shuffle(seed=seed).select(range(sample_size))
    records = []
    for i, item in enumerate(ds):
        caps = [str(c) for c in item["caption"]]
        if len(caps) < 5:
            continue
        records.append({"image": np.asarray(item["image"].convert("RGB")), "captions": caps[:5], "imgid": i})
    return records


def _load_docvqa(sample_size: int, seed: int) -> list[dict]:
    """DocVQA validation split as question->document-image retrieval (the
    v15-era adapter, SURVEY.md §7.4): one question per document image."""
    from datasets import load_dataset

    ds = load_dataset("lmms-lab/DocVQA", "DocVQA", split="validation")
    if sample_size < len(ds):
        ds = ds.shuffle(seed=seed).select(range(sample_size))
    records = []
    for i, item in enumerate(ds):
        q = item.get("question")
        img = item.get("image")
        if not q or img is None:
            continue
        records.append({"image": np.asarray(img.convert("RGB")), "captions": [str(q)], "imgid": i})
    return records


def load_benchmark_dataset(
    name: str,
    cache_dir: "Path | str" = "./coco_images",
    workers: int = 16,
    sample_size: int = 5000,
    seed: int = SEED,
) -> list[dict]:
    """name: 'coco' | 'flickr30k' | 'docvqa' | 'synthetic'."""
    if name == "synthetic":
        return synthetic_retrieval_dataset(min(sample_size, 10_000_000), seed=seed)
    if name == "coco":
        return _load_coco(Path(cache_dir), workers, sample_size, seed)
    if name == "flickr30k":
        return _load_flickr30k(sample_size, seed)
    if name == "docvqa":
        return _load_docvqa(sample_size, seed)
    raise ValueError(f"unknown dataset '{name}'")
