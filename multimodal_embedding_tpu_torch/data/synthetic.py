"""Offline synthetic retrieval dataset.

Network-free stand-in for COCO-Karpathy used by tests, the offline CLI mode
(``--dataset synthetic``) and bench.py: deterministic procedural images (so
preprocessing/encoding see realistic uint8 content at COCO-like geometries)
with 5 captions each that exercise the failure-analysis keyword tables
(spatial/color/counting, COCO supercategories — reference main.py:102-125).
"""

from __future__ import annotations

import numpy as np

_COLORS = {
    "red": (220, 40, 40),
    "blue": (40, 60, 220),
    "green": (40, 200, 80),
    "yellow": (230, 220, 50),
    "black": (20, 20, 20),
    "white": (240, 240, 240),
}
_OBJECTS = ["dog", "cat", "car", "pizza", "chair", "laptop", "person", "bus", "clock", "bed"]
_COUNTS = ["one", "two", "three", "several", "many"]
_SPATIAL = ["on the left", "on the right", "above the table", "behind the fence", "near the window"]
_GEOMETRIES = [(480, 640), (640, 480), (480, 480), (427, 640)]


_BASE_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _gradient_base(h: int, w: int) -> np.ndarray:
    """Pre-cast int16 gradient; only 4 geometries exist, so cache them."""
    base = _BASE_CACHE.get((h, w))
    if base is None:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack(
            [
                (xx * 255 // max(w, 1)).astype(np.uint8),
                (yy * 255 // max(h, 1)).astype(np.uint8),
                ((xx + yy) * 255 // max(h + w, 1)).astype(np.uint8),
            ],
            axis=-1,
        ).astype(np.int16)
        _BASE_CACHE[(h, w)] = base
    return base


def _render_image(rng: np.random.Generator, h: int, w: int, color: tuple) -> np.ndarray:
    base = _gradient_base(h, w).copy()
    # a filled rectangle of the caption color
    for _ in range(int(rng.integers(1, 4))):
        y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
        dy, dx = int(rng.integers(h // 8, h // 2)), int(rng.integers(w // 8, w // 2))
        base[y0 : y0 + dy, x0 : x0 + dx] = np.array(color, np.int16)
    noise = rng.integers(0, 16, size=(h, w, 3), dtype=np.uint8)
    base += noise
    return np.clip(base, 0, 255, out=base).astype(np.uint8)


def synthetic_retrieval_dataset(n: int, seed: int = 42) -> list[dict]:
    """Return n records: {'image': uint8 HWC, 'captions': [5 strings], 'imgid': int}."""
    rng = np.random.default_rng(seed)
    records = []
    color_names = list(_COLORS)
    for i in range(n):
        color = color_names[int(rng.integers(len(color_names)))]
        obj = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
        count = _COUNTS[int(rng.integers(len(_COUNTS)))]
        spatial = _SPATIAL[int(rng.integers(len(_SPATIAL)))]
        h, w = _GEOMETRIES[int(rng.integers(len(_GEOMETRIES)))]
        img = _render_image(rng, h, w, _COLORS[color])
        captions = [
            f"{count} {color} {obj} {spatial}",
            f"a photo of a {color} {obj}",
            f"the {obj} is {spatial} in the picture",
            f"{count} {obj}s can be seen here",
            f"an image showing a {obj} with {color} tones",
        ]
        records.append({"image": img, "captions": captions, "imgid": i})
    return records
