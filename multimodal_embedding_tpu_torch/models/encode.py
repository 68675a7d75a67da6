"""Encoding engine: batched image/text embedding on one device.

Counterpart of ``multimodal_embedding_tpu/models/encode.py``. Raw uint8
images are staged on the device once, grouped by native geometry and
pre-batched (``stage_images``); each batch then runs preprocess (the CUDA
kernel on the card) -> model -> L2 normalize with no host traffic. Text
sweeps run in batches of ``max(batch, 128)``. Every timed result ends in
:func:`~..utils.timing.hard_sync`, so the seconds it reports are device
completion.

Dense models give f32 embeddings [N, E], L2-normalized here. Multi-vector
models (ColPali) give per-token embeddings [N, T, D] in bf16, as the JAX
package stores them; their forward already normalizes each token with
``max(norm, 1e-12)`` and zeroes query pad tokens, so they are not normalized
again: the JAX engine's second ``x / norm`` turns every zero pad vector into
NaN, and here pads stay exact zeros.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.preprocess import make_preprocess_fn
from ..ops.preprocess_cuda import make_preprocess_cuda_fn
from ..utils.timing import hard_sync
from .layers import l2_normalize
from .zoo import LoadedModel

PREPROCESS_IMPLS = ("auto", "xla", "pallas")


@dataclass
class EncodeResult:
    embeddings: torch.Tensor  # [N, E] f32, or [N, T, D] bf16 for multi-vector models
    mask: torch.Tensor | None  # [N, T] token mask of multi-vector texts
    seconds: float


@dataclass
class DeviceImageCache:
    """Raw uint8 images staged on the device, grouped by native geometry and
    pre-batched: each group is a [n_batches, B, 3, H, W] tensor (NCHW)."""

    groups: list[tuple[tuple[int, int], list[int], torch.Tensor, int]]
    # (geometry, original indices, [nb, B, 3, H, W] device tensor, valid count)
    batch_size: int
    n_images: int
    stage_seconds: float


def _group_buffer(images: list[np.ndarray], idxs: list[int], h: int, w: int, batch_size: int) -> np.ndarray:
    """Native HWC images -> one padded [nb, B, 3, H, W] uint8 host buffer
    (padding repeats the last image)."""
    count = len(idxs)
    nb = -(-count // batch_size)
    buf = np.empty((nb * batch_size, 3, h, w), np.uint8)
    for j, i in enumerate(idxs):
        buf[j] = images[i].transpose(2, 0, 1)
    buf[count:] = buf[count - 1]
    return buf.reshape(nb, batch_size, 3, h, w)


def stage_images(images: list[np.ndarray], batch_size: int, device) -> DeviceImageCache:
    """One-time host->device staging of native uint8 images."""
    t0 = time.perf_counter()
    groups_idx: dict[tuple[int, int], list[int]] = {}
    for i, im in enumerate(images):
        groups_idx.setdefault(im.shape[:2], []).append(i)
    groups = []
    for (h, w), idxs in groups_idx.items():
        dev = torch.from_numpy(_group_buffer(images, idxs, h, w, batch_size)).to(device)
        groups.append(((h, w), idxs, dev, len(idxs)))
    hard_sync([g[2] for g in groups])
    return DeviceImageCache(groups, batch_size, len(images), time.perf_counter() - t0)


class EncodingEngine:
    """Preprocess + encode on ``device``. ``preprocess_impl``: "pallas" is the
    CUDA kernel (the name of the TPU package's kernel route), "xla" the
    plain PyTorch matmuls, "auto" the kernel on a CUDA device and the plain
    version on the CPU."""

    def __init__(self, model: LoadedModel, batch_size: int = 32, *, device, preprocess_impl: str = "auto"):
        if preprocess_impl not in PREPROCESS_IMPLS:
            raise ValueError(f"preprocess impl must be one of {PREPROCESS_IMPLS}, not {preprocess_impl!r}")
        self.model = model
        self.device = torch.device(device)
        self.batch_size = batch_size
        if preprocess_impl == "auto":
            preprocess_impl = "pallas" if self.device.type == "cuda" else "xla"
        self.preprocess_impl = preprocess_impl
        self._pre_fns: dict[tuple[int, int], object] = {}

    # --- internals ---

    def _preprocess_fn(self, h: int, w: int):
        key = (h, w)
        if key not in self._pre_fns:
            cfg = self.model.preprocess
            if self.preprocess_impl == "pallas":
                self._pre_fns[key] = make_preprocess_cuda_fn(cfg, h, w, device=self.device)
            else:
                self._pre_fns[key] = make_preprocess_fn(cfg, h, w, device=self.device, input_format="nchw")
        return self._pre_fns[key]

    def _finish(self, emb: torch.Tensor) -> torch.Tensor:
        if self.model.multi_vector:
            return emb.to(torch.bfloat16)
        return l2_normalize(emb).float()

    @torch.inference_mode()
    def _image_batch(self, batch_u8: torch.Tensor, h: int, w: int) -> torch.Tensor:
        px = self._preprocess_fn(h, w)(batch_u8)
        return self._finish(self.model.model.encode_image(px))

    @torch.inference_mode()
    def _text_batch(self, ids: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        return self._finish(self.model.model.encode_text(ids, mask))

    @staticmethod
    def _scatter(chunks: list[tuple[list[int], torch.Tensor]], n: int) -> torch.Tensor:
        if len(chunks) == 1 and chunks[0][0] == list(range(n)):
            return chunks[0][1]  # single in-order group: no scatter copy
        out = torch.empty((n, *chunks[0][1].shape[1:]), dtype=chunks[0][1].dtype, device=chunks[0][1].device)
        for idxs, emb in chunks:
            out[torch.as_tensor(idxs, device=out.device)] = emb
        return out

    # --- public API ---

    def encode_images(self, images: list[np.ndarray]) -> EncodeResult:
        """images: list of HWC uint8 arrays (native geometry); each batch is
        shipped to the device and encoded there."""
        t0 = time.perf_counter()
        groups: dict[tuple[int, int], list[int]] = {}
        for i, im in enumerate(images):
            groups.setdefault(im.shape[:2], []).append(i)
        chunks = []
        for (h, w), idxs in groups.items():
            for s in range(0, len(idxs), self.batch_size):
                bidx = idxs[s : s + self.batch_size]
                batch = np.stack([images[i] for i in bidx]).transpose(0, 3, 1, 2)
                dev = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
                chunks.append((bidx, self._image_batch(dev, h, w)))
        out = hard_sync(self._scatter(chunks, len(images)))
        return EncodeResult(out, None, time.perf_counter() - t0)

    def encode_images_cached(self, cache: DeviceImageCache) -> EncodeResult:
        """Encode from a device-resident image cache, batch by batch; staged
        batches that are a multiple of this engine's batch are split."""
        t0 = time.perf_counter()
        chunks = []
        for (h, w), idxs, dev, count in cache.groups:
            embs = []
            for batch_u8 in dev:
                b = batch_u8.shape[0]
                step = self.batch_size if b % self.batch_size == 0 else b
                for s in range(0, b, step):
                    embs.append(self._image_batch(batch_u8[s : s + step], h, w))
            chunks.append((idxs, torch.cat(embs)[:count]))
        out = hard_sync(self._scatter(chunks, cache.n_images))
        return EncodeResult(out, None, time.perf_counter() - t0)

    def encode_texts(self, texts: list[str]) -> EncodeResult:
        """Tokenize on the host, ship the ids once, encode in batches of
        ``max(batch, 128)`` (text sequences are short)."""
        t0 = time.perf_counter()
        ids, mask = self.model.tokenize(texts)
        n = ids.shape[0]
        bs = max(self.batch_size, 128)
        ids_d = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        mask_d = None if mask is None else torch.from_numpy(mask).to(self.device)
        outs = [
            self._text_batch(ids_d[s : s + bs], None if mask_d is None else mask_d[s : s + bs])
            for s in range(0, n, bs)
        ]
        out = hard_sync(torch.cat(outs))
        out_mask = mask_d if self.model.multi_vector else None
        return EncodeResult(out, out_mask, time.perf_counter() - t0)

    def warmup_texts(self, text_sets: list[list[str]]) -> None:
        """Run each caption set once before timing (first-use costs: kernel
        build and load, allocator growth, cuBLAS handles)."""
        for texts in text_sets:
            if texts:
                self.encode_texts(texts)

    def warmup(self, image_geom: tuple[int, int] = (256, 256), images: bool = True, texts: bool = True,
               text_sets: list[list[str]] | None = None) -> None:
        """First-use costs before timing (reference main.py:536-547's warmup)."""
        h, w = image_geom
        if images:
            self.encode_images([np.zeros((h, w, 3), np.uint8)] * 2)
        if texts:
            self.warmup_texts(text_sets or [["a warmup caption"] * 2])
