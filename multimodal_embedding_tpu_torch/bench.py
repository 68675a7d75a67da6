"""Headline benchmark of the port: OpenAI-CLIP-L (the full ViT-L/14-336
architecture, random weights) image encode throughput on one NVIDIA GPU,
through the device preprocess -> ViT-L -> L2 path from the staged image
cache.

    python -m multimodal_embedding_tpu_torch.bench [--device cuda|cpu]

Prints exactly one JSON line on every exit path:
  success -> {"metric", "value", "unit", "vs_baseline", "device"}
  failure -> {"metric", "value": null, "unit", "vs_baseline": null, "error"}
and exits 0 on success, 1 on failure. Without a CUDA device it fails unless
``--device cpu`` was given (the CPU runs the kernels' plain versions; its
number is no device measurement).

Counterpart of the repository's ``bench.py`` (the JAX package's bench), with
the same workload and baseline: 288 COCO-geometry images (480x640) staged
once (outside the timer, as the reference keeps its disk image cache out of
its timing, main.py:176-182), batch 96, one warmup pass, then three timed
passes from the staged cache. Baseline: the reference's published
OpenAI-CLIP-L throughput on an NVIDIA A40, 60.6 img/s
(benchmark_v28_all_models_combined.csv, BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

METRIC = "clip_l_encode_images_per_sec"
UNIT = "img/s"
BASELINE_CLIP_L_QPS = 60.6  # A40, reference CSV row OpenAI-CLIP-L
MODEL = "OpenAI-CLIP-L"
N_IMAGES = 288
BATCH = 96
PASSES = 3


def bench_images(n: int) -> list[np.ndarray]:
    """``n`` synthetic 480x640 uint8 images: a gradient plus seeded noise."""
    rng = np.random.default_rng(0)
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h), ((xx + yy) * 255 // (h + w))], -1).astype(np.int16)
    return [np.clip(base + rng.integers(0, 32, (h, w, 3)), 0, 255).astype(np.uint8) for _ in range(n)]


def bench_model(device):
    """The bench's model: full-width OpenAI-CLIP-L, random weights from seed
    0, bf16 on the card (f32 on the CPU)."""
    import torch

    from .models.arch import load_arch_model

    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return load_arch_model(MODEL, seed=0, device=device, dtype=dtype)


def run_once(device) -> dict:
    """The measurement: img/s over PASSES timed passes. Raises on failure."""
    import torch

    from .models.encode import EncodingEngine, stage_images
    from .models.layers import set_attention_impl
    from .utils.timing import hard_sync

    device = torch.device(device)
    set_attention_impl("auto")
    engine = EncodingEngine(bench_model(device), BATCH, device=device)
    cache = stage_images(bench_images(N_IMAGES), BATCH, device)  # one-time staging, untimed
    engine.encode_images_cached(cache)  # warmup pass
    t0 = time.perf_counter()
    for _ in range(PASSES):
        hard_sync(engine.encode_images_cached(cache).embeddings)
    qps = PASSES * N_IMAGES / (time.perf_counter() - t0)
    return {
        "metric": METRIC,
        "value": qps,
        "unit": UNIT,
        "vs_baseline": qps / BASELINE_CLIP_L_QPS,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Port bench: OpenAI-CLIP-L image encode throughput")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or, only when asked, the CPU")
    args = p.parse_args(argv)
    try:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        line = run_once(args.device)
    except Exception as e:  # every failure ends in the one error line
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT, "vs_baseline": None,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
