"""PIL-exact resize, crop and normalize: the hand-written Hopper kernel
(``csrc/preprocess.cu``) behind a per-geometry function.

Counterpart of ``multimodal_embedding_tpu/ops/preprocess_pallas.py:
preprocess_pallas``: uint8 ``[B, 3, H, W]`` -> normalized f32 ``[B, C, C, 3]``,
computing what ``ops/preprocess.py:make_preprocess_fn`` computes (f32 FMA
sums, round half to even and clamp after each pass, then the per-channel
scale and shift). The weights are the numpy ones of ``ops/preprocess.py``, so
they equal the JAX package's exactly.

:func:`make_preprocess_cuda_fn` launches the kernel for CUDA tensors and takes
the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import build
from .preprocess import PreprocessConfig, _cropped_weights, make_preprocess_fn, scale_shift

# Kernel launches made by preprocess_cuda (a plain count, read by chip_smoke.py).
launches = 0

_ROWS_PER_TILE = 32
_SMEM_BUDGET = 200 * 1024  # bytes of horizontal-pass rows a block may hold

_c = ctypes
_ARGTYPES = [_c.c_void_p] * 7 + [_c.c_int] * 8 + [_c.c_float] * 6 + [_c.c_void_p]


def nonzero_bands(m: np.ndarray) -> np.ndarray:
    """int32 [rows, 2]: for each row of ``m``, the columns [lo, hi) outside
    which it is exactly zero ((0, 0) for an all-zero row)."""
    nz = m != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, m.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def row_tiles(vband: np.ndarray, c: int) -> tuple[int, np.ndarray]:
    """(rows_per_tile, tiles [ntiles, 2]): for each tile of output rows, the
    union [hlo, hhi) of its rows' vertical bands. The tile height halves
    until a tile's horizontal-pass rows fit in shared memory."""
    rows = _ROWS_PER_TILE
    while True:
        tiles = []
        for o0 in range(0, vband.shape[0], rows):
            band = vband[o0 : o0 + rows]
            band = band[band[:, 1] > band[:, 0]]
            tiles.append((band[:, 0].min(), band[:, 1].max()) if band.size else (0, 1))
        tiles = np.asarray(tiles, np.int32)
        span = int((tiles[:, 1] - tiles[:, 0]).max())
        if span * c * 4 <= _SMEM_BUDGET or rows == 1:
            return rows, tiles
        rows //= 2


@dataclass
class PreprocessWeights:
    """Device-resident kernel operands for one (config, geometry)."""

    h: int
    w: int
    c: int
    whb: torch.Tensor  # [C, htaps] f32: each output column's band of horizontal weights
    hband: torch.Tensor  # [C, 2] int32
    wv: torch.Tensor  # [C, H] f32
    vband: torch.Tensor  # [C, 2] int32
    tiles: torch.Tensor  # [ntiles, 2] int32
    rows_per_tile: int
    max_span: int
    scale: tuple[float, float, float]
    shift: tuple[float, float, float]

    @property
    def taps(self) -> int:
        """Multiply-adds per (image, channel) over the bands: the work the
        function needs with these weights."""
        h_taps = int((self.hband[:, 1] - self.hband[:, 0]).sum()) * self.h
        v_taps = int((self.vband[:, 1] - self.vband[:, 0]).sum()) * self.c
        return h_taps + v_taps


def preprocess_weights(cfg: PreprocessConfig, h: int, w: int, device) -> PreprocessWeights:
    wv_np, wh_np = _cropped_weights(cfg, h, w)
    c = cfg.image_size
    hband, vband = nonzero_bands(wh_np), nonzero_bands(wv_np)
    htaps = max(1, int((hband[:, 1] - hband[:, 0]).max()))
    whb = np.zeros((c, htaps), np.float32)
    for p, (lo, hi) in enumerate(hband):
        whb[p, : hi - lo] = wh_np[p, lo:hi]
    rows, tiles = row_tiles(vband, c)
    scale, shift = scale_shift(cfg)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PreprocessWeights(
        h=h, w=w, c=c, whb=dev(whb), hband=dev(hband), wv=dev(wv_np), vband=dev(vband),
        tiles=dev(tiles), rows_per_tile=rows, max_span=int((tiles[:, 1] - tiles[:, 0]).max()),
        scale=tuple(float(s) for s in scale), shift=tuple(float(s) for s in shift),
    )


def preprocess_cuda(images_u8: torch.Tensor, wts: PreprocessWeights) -> torch.Tensor:
    """Launch the kernel: uint8 [B, 3, H, W] on the card -> f32 [B, C, C, 3]."""
    global launches
    if images_u8.device.type != "cuda" or images_u8.dtype != torch.uint8:
        raise ValueError(f"preprocess kernel takes a uint8 CUDA tensor, not {images_u8.dtype} on {images_u8.device}")
    if images_u8.dim() != 4 or tuple(images_u8.shape[1:]) != (3, wts.h, wts.w):
        raise ValueError(f"expected [B, 3, {wts.h}, {wts.w}], got {tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError("preprocess kernel needs a contiguous NCHW batch")
    if wts.whb.device != images_u8.device:
        raise ValueError("weights and images lie on different devices")
    b = images_u8.shape[0]
    out = torch.empty((b, wts.c, wts.c, 3), dtype=torch.float32, device=images_u8.device)
    fn = build.load("preprocess").preprocess_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        images_u8.data_ptr(), wts.whb.data_ptr(), wts.hband.data_ptr(), wts.wv.data_ptr(),
        wts.vband.data_ptr(), wts.tiles.data_ptr(), out.data_ptr(),
        b, wts.h, wts.w, wts.c, wts.whb.shape[1], wts.rows_per_tile, wts.tiles.shape[0], wts.max_span,
        *wts.scale, *wts.shift, torch.cuda.current_stream(images_u8.device).cuda_stream,
    )
    build.check(code, "preprocess kernel")
    launches += 1
    return out


def make_preprocess_cuda_fn(cfg: PreprocessConfig, h: int, w: int, *, device):
    """fn: uint8 [B, 3, h, w] -> f32 [B, C, C, 3]. On a CUDA ``device`` every
    call launches the kernel; on the CPU it is the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return make_preprocess_fn(cfg, h, w, device=device, input_format="nchw")
    if device.type != "cuda":
        raise ValueError(f"preprocess runs on cuda (kernel) or cpu (plain), not {device}")
    wts = preprocess_weights(cfg, h, w, device)
    return lambda images_u8: preprocess_cuda(images_u8, wts)
