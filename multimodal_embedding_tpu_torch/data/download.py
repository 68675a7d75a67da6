"""Robust threaded image downloader with verified cache.

Same semantics as the reference (main.py:169-218): per-item cache hit with
``PIL.verify()`` revalidation and delete-on-corrupt, 3 retries with
exponential backoff ``0.5 * 2**attempt``, RGB conversion, and a hard abort if
more than 1% of downloads fail. This stays host-side Python by design — it is
network-bound, not compute-bound.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO
from pathlib import Path

from PIL import Image

logger = logging.getLogger("mme_tpu")


def download_image_task(item: dict, cache_dir: Path, max_retries: int = 3) -> tuple[int, bool]:
    idx = item["idx"]
    filepath = cache_dir / f"{item['imgid']}.jpg"

    if filepath.exists():
        try:
            with Image.open(filepath) as img:
                img.verify()
            return idx, True
        except Exception:
            os.remove(filepath)

    import requests

    for attempt in range(max_retries):
        try:
            response = requests.get(item["url"], timeout=10)
            response.raise_for_status()
            image = Image.open(BytesIO(response.content))
            if image.mode != "RGB":
                image = image.convert("RGB")
            image.save(filepath)
            return idx, True
        except Exception:
            if attempt == max_retries - 1:
                return idx, False
            time.sleep(0.5 * (2**attempt))
    return idx, False


def prepare_dataset_cache(ds, cache_dir: Path, workers: int = 16, min_success: float = 0.99) -> None:
    """Download/verify every image; abort (SystemExit) if success < 99%."""
    cache_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f"Preparing dataset: caching images under {cache_dir}")
    tasks = [
        {"idx": idx, "url": item["url"], "imgid": item["imgid"]} for idx, item in enumerate(ds)
    ]
    with ThreadPoolExecutor(max_workers=workers) as executor:
        results = list(executor.map(lambda t: download_image_task(t, cache_dir), tasks))

    valid = sum(1 for _, ok in results if ok)
    rate = 100 * valid / max(len(tasks), 1)
    logger.info(f"Image cache ready: {valid}/{len(tasks)} valid ({rate:.1f}%)")
    if valid < len(tasks) * min_success:
        logger.error(
            f"Download failure rate exceeds {100 * (1 - min_success):.0f}% — "
            "aborting the benchmark (same policy as reference main.py:214-218)."
        )
        raise SystemExit(1)


def load_cached_image(item: dict, cache_dir: Path):
    """Return an RGB PIL image from cache, or None (reference main.py:228-236)."""
    filepath = cache_dir / f"{item['imgid']}.jpg"
    if not filepath.exists():
        return None
    try:
        return Image.open(filepath).convert("RGB")
    except Exception as e:
        logger.error(f"Failed to load cached image {filepath}: {e}")
        return None
