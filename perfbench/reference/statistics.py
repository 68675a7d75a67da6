"""The statistics phase after the bootstrap, in plain NumPy: each metric's
percentile confidence interval and standard deviation, and the failure
analysis of the T2I queries.

The interval follows the reference benchmark (its ``main.py:259-302``):
10,000 resamples of the per-iteration values, the mean of each, and the
2.5th and 97.5th percentiles of those means, in float64. The resamples are
drawn as the port documents them (COMPAT.md #6), since ``numpy``'s global
draws of the original cannot be replayed: ``torch.randint`` on a CPU
``torch.Generator`` seeded with 0, one ``[10000, n]`` call.

The failure analysis follows the reference's keyword tables and its
breakdowns over every (iteration, query) record (``main.py:102-125``,
``:239-256``, ``:669-722``): the share of records whose query found its
image first, overall, with and without each complexity feature, by COCO
supercategory and by caption length. Here the records are counted per
sampled item: how often each was drawn, and how often it was found.
"""

from __future__ import annotations

import numpy as np
import torch

SUPERCATEGORIES: dict[str, list[str]] = {
    "person": ["person"],
    "vehicle": ["bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat"],
    "outdoor": ["traffic light", "fire hydrant", "stop sign", "parking meter", "bench"],
    "animal": ["bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe"],
    "accessory": ["backpack", "umbrella", "handbag", "tie", "suitcase"],
    "sports": ["frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat",
               "baseball glove", "skateboard", "surfboard", "tennis racket"],
    "kitchen": ["bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl"],
    "food": ["banana", "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
             "donut", "cake"],
    "furniture": ["chair", "couch", "potted plant", "bed", "dining table", "toilet"],
    "electronic": ["tv", "laptop", "mouse", "remote", "keyboard", "cell phone"],
    "appliance": ["microwave", "oven", "toaster", "sink", "refrigerator"],
    "indoor": ["book", "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush"],
}
FEATURES = {
    "has_spatial": ["left", "right", "top", "bottom", "above", "below", "next to", "beside",
                    "in front", "behind", "between", "near", "far"],
    "has_color": ["red", "blue", "green", "yellow", "black", "white", "orange", "purple",
                  "pink", "brown", "gray", "grey"],
    "has_counting": ["one", "two", "three", "four", "five", "1", "2", "3", "4", "5",
                     "single", "double", "triple", "multiple", "several", "many", "few"],
}
LENGTH_BINS = [(0, 5), (6, 10), (11, 15), (16, 100)]


def confidence_interval(values, confidence: float = 0.95, n_resamples: int = 10_000,
                        seed: int = 0) -> tuple[float, float, float]:
    """(mean, lower, upper) of ``values`` by the percentile bootstrap."""
    x = np.asarray(values, dtype=np.float64)
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, len(x), (n_resamples, len(x)), generator=gen).numpy()
    alpha = (1.0 - confidence) / 2.0
    lower, upper = np.quantile(x[idx].mean(axis=1), [alpha, 1.0 - alpha])
    return float(x.mean()), float(lower), float(upper)


def summary(metrics: dict[str, np.ndarray]) -> dict[str, tuple[float, float, float, float]]:
    """{metric: (mean, lower, upper, standard deviation)} of per-iteration values."""
    return {k: (*confidence_interval(v), float(np.std(np.asarray(v, dtype=np.float64)))) for k, v in metrics.items()}


def _category(caption: str) -> str | None:
    low = caption.lower()
    for name, words in SUPERCATEGORIES.items():
        if any(w in low for w in words):
            return name
    return None


def failure_analysis(hits: np.ndarray, idx: np.ndarray, captions: list[str]) -> dict[str, float]:
    """The breakdowns, flat: ``overall_accuracy``, ``accuracy_<feature>`` and
    ``accuracy_not_<feature>``, ``accuracy_by_category.<name>``,
    ``accuracy_length_<low>_<high>``; a breakdown with no record is left out.
    hits [I, N] bool: the query at each sample position found its image
    first; idx [I, N]: the item at each position; captions: each item's
    first caption (the T2I query)."""
    n = len(captions)
    drawn = np.bincount(idx.reshape(-1), minlength=n)
    found = np.bincount(idx.reshape(-1), weights=hits.reshape(-1).astype(np.float64), minlength=n)

    def share(mask: np.ndarray) -> float | None:
        total = int(drawn[mask].sum())
        return None if total == 0 else 100.0 * float(found[mask].sum()) / total

    out = {"overall_accuracy": share(np.ones(n, bool))}
    lows = [c.lower() for c in captions]
    for feature, words in FEATURES.items():
        has = np.array([any(w in c for w in words) for c in lows])
        out[f"accuracy_{feature}"] = share(has)
        out[f"accuracy_not_{feature}"] = share(~has)
    cats = np.array([_category(c) or "" for c in captions])
    for name in SUPERCATEGORIES:
        out[f"accuracy_by_category.{name}"] = share(cats == name)
    length = np.array([len(c.split()) for c in captions])
    for low, high in LENGTH_BINS:
        out[f"accuracy_length_{low}_{high}"] = share((length >= low) & (length <= high))
    return {k: v for k, v in out.items() if v is not None}
