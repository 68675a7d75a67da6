"""PIL-exact image preprocessing as two resize matmuls, in plain PyTorch.

Counterpart of ``multimodal_embedding_tpu/ops/preprocess.py``. PIL's
resampler is separable: a horizontal and a vertical pass, each a fixed linear
map per (in_size, out_size). The weight matrices are built on the host in
numpy (a verbatim copy of the JAX package's builders, so both packages use
identical weights) with the center crop folded in, and the image path is

    out = normalize(quant(Wv @ quant(img @ Wh^T)))

with round-half-to-even and clamp to [0, 255] after each pass (Pillow
Resample.c pass order). Differences to PIL are at most one uint8 level.
This plain version is the reference of the CUDA kernel in
``ops/preprocess_cuda.py``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

# --- Filters (PIL definitions) ---


def _bicubic(x: np.ndarray) -> np.ndarray:
    # PIL's cubic filter, a = -0.5 (Pillow Resample.c bicubic_filter)
    a = -0.5
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


_FILTERS = {
    "bicubic": (_bicubic, 2.0),
    "bilinear": (_bilinear, 1.0),
}


@functools.lru_cache(maxsize=4096)
def _resize_matrix_cached(in_size: int, out_size: int, interpolation: str) -> np.ndarray:
    filt, support_base = _FILTERS[interpolation]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    ss = 1.0 / filterscale

    xx = np.arange(out_size, dtype=np.float64)
    center = (xx + 0.5) * scale
    xmin = np.maximum(0, np.floor(center - support).astype(np.int64))
    xmax = np.minimum(in_size, np.ceil(center + support).astype(np.int64))

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    src = np.arange(in_size, dtype=np.float64)
    for i in range(out_size):
        lo, hi = xmin[i], xmax[i]
        w = filt((src[lo:hi] - center[i] + 0.5) * ss)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, lo:hi] = w
    return mat.astype(np.float32)


def pil_resize_matrix(in_size: int, out_size: int, interpolation: str = "bicubic") -> np.ndarray:
    """[out_size, in_size] float32 matrix reproducing PIL 1-D resampling."""
    return _resize_matrix_cached(in_size, out_size, interpolation)


# --- Geometry (HF image-processor semantics) ---


def shortest_edge_size(h: int, w: int, size: int) -> tuple[int, int]:
    """HF ``get_resize_output_image_size(default_to_square=False)``."""
    short, long = (h, w) if h <= w else (w, h)
    new_short = size
    new_long = int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)


@dataclass(frozen=True)
class PreprocessConfig:
    """Per-model preprocessing recipe (mirrors the model's HF processor)."""

    image_size: int  # final square side fed to the ViT
    resize_mode: Literal["shortest_edge", "exact"] = "shortest_edge"
    interpolation: str = "bicubic"
    mean: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)  # OPENAI_CLIP
    std: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    rescale: float = 1.0 / 255.0

    def resize_target(self, h: int, w: int) -> tuple[int, int]:
        if self.resize_mode == "exact":
            return (self.image_size, self.image_size)
        return shortest_edge_size(h, w, self.image_size)


# normalize constants shared by model configs
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def _cropped_weights(cfg: PreprocessConfig, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Vertical/horizontal resize matrices with the center crop folded in.

    Returns (Wv [C, h], Wh [C, w]) such that out = Wv @ img @ Wh^T is the
    resized-then-center-cropped image (HF center_crop: top-left offset
    ``(size - crop) // 2``).
    """
    rh, rw = cfg.resize_target(h, w)
    c = cfg.image_size
    if rh < c or rw < c:
        raise ValueError(f"resize target {(rh, rw)} smaller than crop {c}")
    wv = pil_resize_matrix(h, rh, cfg.interpolation)
    wh = pil_resize_matrix(w, rw, cfg.interpolation)
    top = (rh - c) // 2
    left = (rw - c) // 2
    return wv[top : top + c], wh[left : left + c]


def scale_shift(cfg: PreprocessConfig) -> tuple[np.ndarray, np.ndarray]:
    """x/255 then (x-mean)/std  ==  x * scale + shift, per channel, f32."""
    std = np.asarray(cfg.std, np.float32)
    scale = (cfg.rescale / std).astype(np.float32)
    shift = (-np.asarray(cfg.mean, np.float32) / std).astype(np.float32)
    return scale, shift


def _quant(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0)  # round half to even, like jnp.round


def make_preprocess_fn(
    cfg: PreprocessConfig, h: int, w: int, *, device, pil_rounding: bool = True,
    input_format: str = "nhwc",
):
    """Build fn: uint8 [B,h,w,3] (or [B,3,h,w] with input_format='nchw') on
    ``device`` -> float32 [B,C,C,3] normalized (NHWC)."""
    wv_np, wh_np = _cropped_weights(cfg, h, w)
    scale_np, shift_np = scale_shift(cfg)
    wv = torch.from_numpy(wv_np).to(device)
    wh = torch.from_numpy(wh_np).to(device)
    scale = torch.from_numpy(scale_np).to(device)[None, :, None, None]
    shift = torch.from_numpy(shift_np).to(device)[None, :, None, None]

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        if input_format == "nchw":
            x = images_u8.float()  # [B,3,h,w]
        else:
            x = images_u8.permute(0, 3, 1, 2).float()
        # horizontal pass (contract w), then vertical (contract h): PIL order
        x = torch.einsum("bchw,wp->bchp", x, wh.T)
        if pil_rounding:
            x = _quant(x)
        x = torch.einsum("bchp,ho->bcop", x, wv.T)
        if pil_rounding:
            x = _quant(x)
        x = x * scale + shift
        return x.permute(0, 2, 3, 1)  # [B,C,C,3] NHWC

    return fn


_PIL_RESAMPLE = {"bicubic": 3, "bilinear": 2}  # PIL.Image.BICUBIC / BILINEAR


def host_resize_crop(cfg: PreprocessConfig, img: np.ndarray) -> np.ndarray:
    """PIL resize + center crop on the host -> uint8 [C, C, 3] (the HF
    processor's geometry stage; the "host" transport of the encoding
    engine, which then normalizes on the device)."""
    from PIL import Image

    h, w = img.shape[:2]
    rh, rw = cfg.resize_target(h, w)
    pil = Image.fromarray(img)
    if (rh, rw) != (h, w):
        pil = pil.resize((rw, rh), resample=_PIL_RESAMPLE[cfg.interpolation])
    c = cfg.image_size
    top = (rh - c) // 2
    left = (rw - c) // 2
    return np.asarray(pil)[top : top + c, left : left + c]


def make_normalize_fn(cfg: PreprocessConfig, input_format: str = "nchw", *, device):
    """Normalize-only fn for crop-sized uint8 on ``device``.

    Input [B, 3, C, C] NCHW by default; output [B, C, C, 3] NHWC f32.
    """
    scale_np, shift_np = scale_shift(cfg)
    scale = torch.from_numpy(scale_np).to(device)
    shift = torch.from_numpy(shift_np).to(device)

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        if input_format == "nchw":
            x = images_u8.float() * scale[None, :, None, None] + shift[None, :, None, None]
            return x.permute(0, 2, 3, 1)
        return images_u8.float() * scale + shift

    return fn
