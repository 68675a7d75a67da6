"""V28-style publication benchmark: multi-seed deterministic runs + Winoground.

Counterpart of ``multimodal_embedding_tpu/cli/multi_seed.py``, mirroring the
reference ``run_benchmark_grand_slam_v28_publication_ready.py``: per model,
Winoground runs once, COCO runs ``--runs`` times with seeds SEED+i
(shuffle+select per run), per-metric "mean ± std" strings, the
REFERENCE_RANGES sanity check (v28:90-94, :595-599) and per-model CSV
checkpointing with the published column order (Model, Weights, Wino
Text/Image/Group, T2I_R@K, I2T_R@K, Time, QPS, Img/s). By default each model
encodes the pool once and every run indexes its subset of the pool's
embeddings (COMPAT #13); ``--per-run-encode`` re-encodes each run as the
reference does. Runs on ``--device`` (default cuda; without a CUDA device it
exits nonzero unless ``--device cpu`` was given).

    python -m multimodal_embedding_tpu_torch.cli.multi_seed --dataset synthetic \\
        --arch-models --models OpenAI-CLIP-L,ColPali-v1.3 --sample-size 512 --runs 3
"""

from __future__ import annotations

import argparse
import logging
import time
import traceback

import numpy as np
import pandas as pd
import torch

from ..analysis.winoground import load_winoground, run_winoground
from ..data.captions import caps_per_image
from ..data.coco import load_benchmark_dataset
from ..models.encode import EncodingEngine, stage_images
from ..models.registry import get_models_to_test
from ..parallel.mesh import distributed, is_writer, world_size
from ..retrieval.metrics import compute_metrics
from ..retrieval.scoring import dense_scores, late_interaction_scores
from ..utils.logging import setup_logging
from .main import data_mesh, device_arg, load_model_for

logger = logging.getLogger("mme_tpu")

SEED = 42

# Published T2I R@1 sanity bands (reference v28:90-94)
REFERENCE_RANGES = {
    "OpenAI-CLIP-L": {"T2I_R@1": (35.0, 40.0)},
    "SigLIP-400M": {"T2I_R@1": (45.0, 55.0)},
    "LAION-CLIP-H": {"T2I_R@1": (40.0, 50.0)},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Grand Slam Benchmark V28 (publication) — PyTorch/CUDA")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--sample-size", type=int, default=5000)
    p.add_argument("--runs", type=int, default=3, help="Number of seeded runs (v28:62)")
    p.add_argument("--output", type=str, default="benchmark_v28_results.csv")
    p.add_argument("--cache-dir", type=str, default="./coco_images")
    p.add_argument("--models", type=str, default="all")
    p.add_argument("--dataset", type=str, default="coco", choices=["coco", "flickr30k", "docvqa", "synthetic"])
    p.add_argument("--debug-models", action="store_true")
    p.add_argument("--arch-models", action="store_true",
                   help="Random-init towers at the FULL published architecture")
    p.add_argument("--skip-winoground", action="store_true")
    p.add_argument("--winoground-samples", type=int, default=None)
    p.add_argument("--mrr", action="store_true", help="Also report MRR (v15-v19 metric)")
    p.add_argument("--maxsim-impl", type=str, default="auto", choices=["auto", "pallas", "xla"])
    p.add_argument("--per-run-encode", action="store_true",
                   help="Re-encode every seeded run like the reference v28 "
                        "(default: encode the pool once and index per-run "
                        "subsets — identical results, COMPAT.md #13)")
    p.add_argument("--device-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="Stage pool images to device memory once (encode-once mode)")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun), cuda:N or, only when asked, cpu")
    return p.parse_args(argv)


def _scores(model, img_e, txt_e, all_e, maxsim_impl):
    if model.multi_vector:
        return (late_interaction_scores(txt_e, img_e, impl=maxsim_impl),
                late_interaction_scores(img_e, all_e, impl=maxsim_impl))
    return dense_scores(txt_e, img_e), dense_scores(img_e, all_e)


def run_benchmark_coco(model, engine, records, maxsim_impl="auto", include_mrr=False) -> dict:
    """Single-pass deterministic run (v28:231-411): encode, score, metrics."""
    kc = caps_per_image(records)
    images = [r["image"] for r in records]
    t2i_caps = [r["captions"][0] for r in records]
    all_caps = [c for r in records for c in r["captions"][:kc]]

    t0 = time.perf_counter()
    img = engine.encode_images(images)
    txt = engine.encode_texts(t2i_caps)
    txt_all = engine.encode_texts(all_caps)
    enc_time = time.perf_counter() - t0

    s_t2i, s_i2t = _scores(model, img.embeddings, txt.embeddings, txt_all.embeddings, maxsim_impl)
    metrics = compute_metrics(s_t2i, s_i2t, s_t2i.T, include_mrr=include_mrr, caps_per_image=kc)
    metrics["Time"] = time.perf_counter() - t0
    metrics["QPS"] = len(images) / enc_time
    metrics["Img/s"] = len(images) / enc_time
    return metrics


def encode_pool(engine, pool, cache=None):
    """Encode the whole pool once per model (images from the device cache when
    staged, both caption sets). Seeded runs then index into these
    embeddings: every per-sample op of the towers is independent of the rest
    of the batch, so a subset's embeddings are the same whether encoded alone
    or in the pool. Warmup runs first, outside the timer."""
    kc = caps_per_image(pool)
    t2i_caps = [r["captions"][0] for r in pool]
    all_caps = [c for r in pool for c in r["captions"][:kc]]
    if cache is not None:
        engine.encode_images_cached(cache)
    else:
        for geom in {r["image"].shape[:2] for r in pool}:
            engine.warmup(geom, texts=False)
    engine.warmup_texts([t2i_caps, all_caps])

    t0 = time.perf_counter()
    img = (engine.encode_images_cached(cache) if cache is not None
           else engine.encode_images([r["image"] for r in pool]))
    txt = engine.encode_texts(t2i_caps)
    txt_all = engine.encode_texts(all_caps)
    enc_time = time.perf_counter() - t0
    return img, txt, txt_all, kc, enc_time


def run_metrics_from_pool(model, img, txt, txt_all, kc, idx, n_pool, enc_time,
                          maxsim_impl="auto", include_mrr=False) -> dict:
    """One seeded run's metrics from the pool encode: gather the run's rows,
    score, compute metrics. QPS keeps the reference semantics (images per
    encode-phase second), measured over the pool encode."""
    t0 = time.perf_counter()
    dev = img.embeddings.device
    idx = np.asarray(idx)
    img_e = img.embeddings[torch.as_tensor(idx, device=dev)]
    txt_e = txt.embeddings[torch.as_tensor(idx, device=dev)]
    cap_idx = (idx[:, None] * kc + np.arange(kc)[None, :]).reshape(-1)
    all_e = txt_all.embeddings[torch.as_tensor(cap_idx, device=dev)]

    s_t2i, s_i2t = _scores(model, img_e, txt_e, all_e, maxsim_impl)
    metrics = compute_metrics(s_t2i, s_i2t, s_t2i.T, include_mrr=include_mrr, caps_per_image=kc)
    metrics["Time"] = enc_time + (time.perf_counter() - t0)
    metrics["QPS"] = n_pool / enc_time
    metrics["Img/s"] = n_pool / enc_time
    return metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    with distributed(args.device) as device:
        return _run(args, device)


def _run(args, device) -> int:
    # rank 0 keeps the log and writes the CSV; each rank encodes its rows
    setup_logging(**({"log_file": "benchmark_v28.log"} if is_writer() else {"log_file": None,
                                                                          "level": logging.WARNING}))
    mesh = data_mesh()
    logger.info(f"V28 MULTI-SEED BENCHMARK — runs={args.runs}, device={device}, "
                f"mesh={None if mesh is None else mesh.shape}")

    if args.dataset != "synthetic":
        pool = load_benchmark_dataset(args.dataset, cache_dir=args.cache_dir, workers=args.workers,
                                      sample_size=10**9, seed=SEED)  # full pool; per-run sampling below
    else:
        pool = load_benchmark_dataset("synthetic", sample_size=max(args.sample_size * 2, args.sample_size + 8),
                                      seed=SEED)

    wino_records = []
    if not args.skip_winoground:
        try:
            wino_records = load_winoground(sample_size=args.winoground_samples,
                                           synthetic=args.dataset == "synthetic")
        except Exception as e:  # the benchmark runs on without Winoground, as the reference does
            logger.error(f"Failed to load Winoground: {e}")

    cache = None
    if not args.per_run_encode and args.device_cache:
        cache = stage_images([r["image"] for r in pool], args.batch_size, device, mesh)
        logger.info(f"Staged {cache.n_images} pool images to {device} in {cache.stage_seconds:.1f}s "
                    f"(one-time, shared by all models)")

    results = []
    for info in get_models_to_test(args.models, args.batch_size):
        logger.info(f"=== {info.name} ===")
        try:
            model = load_model_for(info, debug=args.debug_models, arch=args.arch_models, seed=SEED, device=device)
        except Exception as e:  # per-model skip-and-continue, as the reference
            if world_size() > 1:  # the ranks' collectives would part ways
                raise
            logger.error(f"Model Load Failed for {info.name}: {e}")
            continue

        try:
            engine = EncodingEngine(model, info.batch_size or args.batch_size, device=device, mesh=mesh)
            wino = run_winoground(engine, wino_records) if wino_records else {}

            pool_enc = None
            if not args.per_run_encode:
                pool_enc = encode_pool(engine, pool, cache=cache)
                logger.info(f"  Pool encoded once in {pool_enc[4]:.1f}s ({len(pool)} images, runs index into it)")

            runs = []
            for run_idx in range(args.runs):
                seed = SEED + run_idx
                logger.info(f"  ▶ RUN {run_idx + 1}/{args.runs} (Seed={seed})")
                if args.sample_size < len(pool):
                    sel = np.random.default_rng(seed).permutation(len(pool))[: args.sample_size]
                else:
                    sel = np.arange(len(pool))
                if pool_enc is not None:
                    img, txt, txt_all, kc, enc_time = pool_enc
                    m = run_metrics_from_pool(model, img, txt, txt_all, kc, sel, len(pool), enc_time,
                                              args.maxsim_impl, args.mrr)
                else:
                    m = run_benchmark_coco(model, engine, [pool[i] for i in sel], args.maxsim_impl, args.mrr)
                runs.append(m)

                if info.name in REFERENCE_RANGES:
                    lo, hi = REFERENCE_RANGES[info.name]["T2I_R@1"]
                    val = m.get("T2I_R@1", 0.0)
                    if not (lo <= val <= hi):
                        logger.warning(f"⚠️ {info.name} T2I_R@1 ({val:.1f}%) OUT OF RANGE ({lo}, {hi}) "
                                       f"for Run {run_idx + 1}")

            # random-weight rows must never read as accuracy evidence
            row: dict = {"Model": info.name, "Weights": model.weights_provenance}
            for k, v in wino.items():
                row[k] = f"{v:.1f}"
            for k in runs[0]:
                vals = [r[k] for r in runs if k in r]
                row[k] = f"{np.mean(vals):.1f} ± {np.std(vals):.1f}"
            results.append(row)
            if is_writer():
                pd.DataFrame(results).to_csv(args.output, index=False)
                logger.info(f"  ✅ Saved checkpoint to {args.output}")
        except Exception as e:  # per-model skip-and-continue, as the reference
            if world_size() > 1:
                raise
            logger.error(f"Evaluation Failed for {info.name}: {e}")
            traceback.print_exc()
        finally:
            del model

    logger.info("BENCHMARK COMPLETE.")
    if not results:
        logger.error("No model produced results — benchmark failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
