"""The HF image processor's geometry and normalization, in plain PyTorch.

PIL resamples separably, a horizontal pass and then a vertical one, each a
fixed linear map from the input length to the output length (Pillow
``Resample.c``), rounding to uint8 (half to even) and clamping after each
pass. The maps are built here on the host in float64, with the center crop
of the HF processor folded in; then ``(x / 255 - mean) / std``. A frozen
copy of PIL's filters, kept apart from the port's.
"""

from __future__ import annotations

import numpy as np
import torch


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    ax = np.abs(x)
    inner = (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
    outer = a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def resize_matrix(in_size: int, out_size: int, interpolation: str) -> np.ndarray:
    """[out_size, in_size]: PIL's 1-D resampling as a matrix."""
    filt, support_base = _FILTERS[interpolation]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    mat = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(0, int(np.floor(center - support)))
        hi = min(in_size, int(np.ceil(center + support)))
        w = filt((np.arange(lo, hi) - center + 0.5) / filterscale)
        if w.sum() != 0:
            w = w / w.sum()
        mat[i, lo:hi] = w
    return mat


def resize_target(recipe: dict, h: int, w: int) -> tuple[int, int]:
    """HF's output size: the square itself ("exact"), or the shortest edge
    to the crop size with the long edge scaled and truncated."""
    size = recipe["image_size"]
    if recipe["resize_mode"] == "exact":
        return size, size
    short, long = (h, w) if h <= w else (w, h)
    new_long = int(size * long / short)
    return (size, new_long) if h <= w else (new_long, size)


def preprocess(images: torch.Tensor, recipe: dict) -> torch.Tensor:
    """uint8 [B, 3, H, W] -> float32 [B, 3, C, C], normalized."""
    _, _, h, w = images.shape
    rh, rw = resize_target(recipe, h, w)
    c = recipe["image_size"]
    top, left = (rh - c) // 2, (rw - c) // 2
    wv = resize_matrix(h, rh, recipe["interpolation"])[top : top + c]
    wh = resize_matrix(w, rw, recipe["interpolation"])[left : left + c]
    dev = images.device
    wv = torch.from_numpy(wv.astype(np.float32)).to(dev)
    wh = torch.from_numpy(wh.astype(np.float32)).to(dev)
    x = images.float() @ wh.T  # [B, 3, H, C]
    x = torch.round(x).clamp_(0.0, 255.0)
    x = wv @ x  # [B, 3, C, C]
    x = torch.round(x).clamp_(0.0, 255.0)
    mean = torch.tensor(recipe["mean"], dtype=torch.float32, device=dev)[:, None, None]
    std = torch.tensor(recipe["std"], dtype=torch.float32, device=dev)[:, None, None]
    return (x / 255.0 - mean) / std
