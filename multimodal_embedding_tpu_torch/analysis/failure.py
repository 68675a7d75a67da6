"""Query-complexity / category failure analysis.

Keyword tables and semantics are identical to the reference
(main.py:102-125 keyword tables, :239-256 per-caption analysis, :669-722
aggregation). The aggregation differs in *where* it runs: the reference
flattens millions of per-(iteration, query) python dicts; here the per-query
features are computed once on the host, and the accuracy breakdowns are
weighted reductions over the device-produced ``correct_r1[iters, N]`` /
``sample_idx[iters, N]`` arrays.
"""

from __future__ import annotations

import numpy as np

COCO_SUPERCATEGORIES: dict[str, list[str]] = {
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

SPATIAL_KEYWORDS = ["left", "right", "top", "bottom", "above", "below", "next to", "beside",
                    "in front", "behind", "between", "near", "far"]
COLOR_KEYWORDS = ["red", "blue", "green", "yellow", "black", "white", "orange", "purple",
                  "pink", "brown", "gray", "grey"]
COUNTING_KEYWORDS = ["one", "two", "three", "four", "five", "1", "2", "3", "4", "5",
                     "single", "double", "triple", "multiple", "several", "many", "few"]

LENGTH_BINS = [(0, 5), (6, 10), (11, 15), (16, 100)]


def analyze_query_complexity(caption: str) -> dict:
    cl = caption.lower()
    return {
        "has_spatial": any(kw in cl for kw in SPATIAL_KEYWORDS),
        "has_color": any(kw in cl for kw in COLOR_KEYWORDS),
        "has_counting": any(kw in cl for kw in COUNTING_KEYWORDS),
        "length": len(caption.split()),
    }


def get_category_from_caption(caption: str) -> str | None:
    cl = caption.lower()
    for supercategory, keywords in COCO_SUPERCATEGORIES.items():
        for keyword in keywords:
            if keyword in cl:
                return supercategory
    return None


def build_query_features(captions: list[str]) -> dict[str, np.ndarray]:
    """Per-query boolean/int feature arrays for the T2I query captions."""
    n = len(captions)
    feats = {
        "has_spatial": np.zeros(n, bool),
        "has_color": np.zeros(n, bool),
        "has_counting": np.zeros(n, bool),
        "length": np.zeros(n, np.int32),
    }
    cats = np.full(n, -1, np.int32)
    cat_names = list(COCO_SUPERCATEGORIES)
    for i, cap in enumerate(captions):
        c = analyze_query_complexity(cap)
        feats["has_spatial"][i] = c["has_spatial"]
        feats["has_color"][i] = c["has_color"]
        feats["has_counting"][i] = c["has_counting"]
        feats["length"][i] = c["length"]
        cat = get_category_from_caption(cap)
        if cat is not None:
            cats[i] = cat_names.index(cat)
    feats["category"] = cats
    return feats


def _masked_acc(correct: np.ndarray, weight: np.ndarray) -> float | None:
    """correct: [iters, N] bool; weight: [iters, N] bool mask over records."""
    total = int(weight.sum())
    if total == 0:
        return None
    return 100.0 * float((correct & weight).sum()) / total


def aggregate_failure_analysis(
    correct_r1: np.ndarray,  # [iters, N] bool
    sample_idx: np.ndarray,  # [iters, N] int
    captions: list[str],
) -> dict:
    """Reference-identical breakdowns (main.py:669-722): overall accuracy,
    per complexity-feature (with/without), per category, per length bin —
    over all (iteration, query) records."""
    feats = build_query_features(captions)
    analysis: dict = {}

    analysis["overall_accuracy"] = 100.0 * float(correct_r1.mean())

    for feature in ["has_spatial", "has_color", "has_counting"]:
        f = feats[feature][sample_idx]  # [iters, N] bool
        acc_with = _masked_acc(correct_r1, f)
        acc_without = _masked_acc(correct_r1, ~f)
        if acc_with is not None:
            analysis[f"accuracy_{feature}"] = acc_with
        if acc_without is not None:
            analysis[f"accuracy_not_{feature}"] = acc_without

    cat = feats["category"][sample_idx]  # [iters, N] int
    category_acc = {}
    for ci, cname in enumerate(COCO_SUPERCATEGORIES):
        acc = _masked_acc(correct_r1, cat == ci)
        if acc is not None:
            category_acc[cname] = acc
    analysis["accuracy_by_category"] = category_acc

    length = feats["length"][sample_idx]
    for low, high in LENGTH_BINS:
        acc = _masked_acc(correct_r1, (length >= low) & (length <= high))
        if acc is not None:
            analysis[f"accuracy_length_{low}_{high}"] = acc

    return analysis
