"""V29-statistical benchmark CLI on one NVIDIA GPU.

Counterpart of ``multimodal_embedding_tpu/cli/main.py``: the same flags and
the same CSV schema, ``Model``, ``Weights``, ``{metric}_{mean,lower,upper,
std}`` for {T2I, I2T, I2T_Sym} x R@{1,5,10}, then ``Time``, ``QPS``,
``Encoding_Time``, ``Img_per_sec`` and ``_failure_analysis`` (reference
main.py:643-665). QPS = images / encode-phase seconds, where the encode
phase covers the images and both text sweeps (reference main.py:493-497);
warmup runs before the timer.

``--device {cuda,cpu}`` picks the device (default cuda); without a CUDA
device the CLI exits nonzero unless ``--device cpu`` was given. Flags of the
JAX CLI that this port does not carry yet raise "not yet ported".

Without ``--debug-models`` or ``--arch-models`` each model loads its HF
checkpoint (``models/zoo.py:load_model``) from the local HF cache; with
``--native-cache-dir`` the dense and siglip models' converted weights are
kept there and reloaded without transformers. A model whose load fails is
logged and skipped.

    python -m multimodal_embedding_tpu_torch.cli.main --dataset synthetic \\
        --arch-models --models OpenAI-CLIP-L --sample-size 512
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import traceback

import numpy as np
import pandas as pd
import torch

from ..analysis.failure import aggregate_failure_analysis
from ..data.captions import caps_per_image
from ..data.coco import load_benchmark_dataset
from ..models.encode import DeviceImageCache, EncodingEngine, stage_images
from ..models.registry import get_models_to_test
from ..models.zoo import LoadedModel, load_debug_model, load_model
from ..retrieval.scoring import dense_scores, late_interaction_scores
from ..stats.bootstrap import bootstrap_benchmark
from ..stats.ci import bootstrap_confidence_interval
from ..utils.logging import setup_logging
from ..utils.memory import device_memory_stats, report_memory
from ..utils.profiling import maybe_trace

logger = logging.getLogger("mme_tpu")

SEED = 42


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Grand Slam Multimodal Benchmark V29 (Statistical) — PyTorch/CUDA")
    p.add_argument("--batch-size", type=int, default=32, help="Batch size for dense models")
    p.add_argument("--workers", type=int, default=16, help="Download workers")
    p.add_argument("--sample-size", type=int, default=5000,
                   help="Number of COCO samples per bootstrap iteration")
    p.add_argument("--bootstrap-iterations", type=int, default=1000,
                   help="Number of bootstrap iterations")
    p.add_argument("--output", type=str, default="benchmark_v29_statistical_results.csv",
                   help="Output CSV file")
    p.add_argument("--cache-dir", type=str, default="./coco_images", help="Image cache directory")
    p.add_argument("--models", type=str, default="all",
                   help="Comma-separated model names or 'all'")
    p.add_argument("--dataset", type=str, default="coco",
                   choices=["coco", "flickr30k", "docvqa", "synthetic"])
    p.add_argument("--debug-models", action="store_true",
                   help="Random-init small towers (offline smoke runs)")
    p.add_argument("--arch-models", action="store_true",
                   help="Random-init towers at the FULL published architecture "
                        "(perf runs without checkpoint access)")
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or, only when asked, the CPU")
    p.add_argument("--maxsim-impl", type=str, default="auto", choices=["auto", "pallas", "xla"],
                   help="Multi-vector (ColPali) scoring: auto and pallas (the MaxSim "
                        "CUDA kernel on the card), or the plain PyTorch version (xla); "
                        "on the CPU always the plain version")
    p.add_argument("--transport", type=str, default="auto", choices=["auto", "host", "device"],
                   help="Image transport: on-device resize (host: not yet ported)")
    p.add_argument("--device-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="Stage raw images to device memory once, shared across models")
    p.add_argument("--overlap-staging", action=argparse.BooleanOptionalAction, default=True,
                   help="Accepted for the JAX CLI's command lines; staging runs "
                        "before the first model, outside the timed encode either way")
    p.add_argument("--streaming-encode", action=argparse.BooleanOptionalAction, default=False,
                   help="Not yet ported")
    p.add_argument("--encode-passes", type=int, default=1,
                   help="Run the encode phase N times and report the median encoding_time/QPS")
    p.add_argument("--score-cache-dir", type=str, default=None, help="Not yet ported")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Capture a torch.profiler trace of each model's benchmark")
    p.add_argument("--attention-impl", type=str, default="auto",
                   choices=["auto", "xla", "xla_bf16", "pallas", "flash"],
                   help="Tower self-attention: auto (the fused CUDA kernel on the "
                        "card, f32-logit SDPA on the CPU), f32-logit SDPA, "
                        "bf16-logit SDPA, or the fused kernel ('pallas')")
    p.add_argument("--preprocess-impl", type=str, default="auto", choices=["auto", "xla", "pallas"],
                   help="Device preprocessing: auto (the CUDA kernel on the card, "
                        "plain matmuls on the CPU), plain matmuls, or the kernel ('pallas')")
    p.add_argument("--layer-impl", type=str, default="auto", choices=["auto", "xla", "fused"],
                   help="Encoder layer: auto and xla (plain ops), or fused (the "
                        "residual+LayerNorm+matmul prologue CUDA kernel feeding the "
                        "stacked-QKV attention kernel; their plain versions on the CPU)")
    p.add_argument("--native-cache-dir", type=str, default=None,
                   help="Keep the dense and siglip models' converted weights as .npz here "
                        "and reload them without transformers")
    p.add_argument("--tensor-parallel", type=int, default=1, help="Values above 1: not yet ported")
    p.add_argument("--sequence-parallel", type=int, default=1, help="Values above 1: not yet ported")
    return p.parse_args(argv)


def _reject_unported(args) -> None:
    unported = {
        "--attention-impl flash": args.attention_impl == "flash",
        "--tensor-parallel above 1": args.tensor_parallel > 1,
        "--sequence-parallel above 1": args.sequence_parallel > 1,
        "--transport host": args.transport == "host",
        "--streaming-encode": args.streaming_encode,
        "--score-cache-dir": args.score_cache_dir is not None,
    }
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f"{flag} is not yet ported to the PyTorch/CUDA package")


def resolve_device(name: str) -> torch.device:
    """The run's device; never falls back from the card to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    return torch.device(name)


def compute_score_matrices(
    model: LoadedModel,
    engine: EncodingEngine,
    records: list[dict],
    cache: DeviceImageCache | None = None,
    maxsim_impl: str = "auto",
):
    """Encode once, build the two full score matrices. Returns
    (s_t2i [N,N], s_i2t [N,K*N], encoding_time)."""
    kc = caps_per_image(records)
    t2i_captions = [r["captions"][0] for r in records]  # T2I uses the first caption
    all_captions = [c for r in records for c in r["captions"][:kc]]

    t0 = time.perf_counter()
    if cache is not None:
        img = engine.encode_images_cached(cache)
    else:
        img = engine.encode_images([r["image"] for r in records])
    txt_t2i = engine.encode_texts(t2i_captions)
    txt_all = engine.encode_texts(all_captions)
    encoding_time = time.perf_counter() - t0

    if model.multi_vector:
        # no masks: pad-token embeddings are exact zeros (COMPAT #8),
        # reproducing colpali_engine's scoring
        s_t2i = late_interaction_scores(txt_t2i.embeddings, img.embeddings, impl=maxsim_impl)
        s_i2t = late_interaction_scores(img.embeddings, txt_all.embeddings, impl=maxsim_impl)
    else:
        s_t2i = dense_scores(txt_t2i.embeddings, img.embeddings)
        s_i2t = dense_scores(img.embeddings, txt_all.embeddings)
    return s_t2i, s_i2t, encoding_time


def run_bootstrap_benchmark(
    model: LoadedModel,
    records: list[dict],
    n_iterations: int,
    *,
    device,
    batch_size: int = 32,
    seed: int = SEED,
    cache: DeviceImageCache | None = None,
    preprocess_impl: str = "auto",
    maxsim_impl: str = "auto",
    encode_passes: int = 1,
    sample_idx: np.ndarray | None = None,
    ci_idx: np.ndarray | None = None,
) -> dict:
    """Encode-once / resample-many (reference main.py:478-667). ``sample_idx``
    and ``ci_idx`` replay given bootstrap and CI resamples."""
    logger.info(f"Benchmarking {model.info.name} with {n_iterations} bootstrap iterations...")
    n = len(records)
    engine = EncodingEngine(model, model.info.batch_size or batch_size, device=device,
                            preprocess_impl=preprocess_impl)
    logger.info("Warming up...")
    kc = caps_per_image(records)
    text_sets = [[r["captions"][0] for r in records], [c for r in records for c in r["captions"][:kc]]]
    if cache is not None:
        engine.encode_images_cached(cache)
        engine.warmup(images=False, text_sets=text_sets)
    else:
        for g in {r["image"].shape[:2] for r in records}:
            engine.warmup(g, text_sets=text_sets)

    t_start = time.perf_counter()
    s_t2i, s_i2t, encoding_time = compute_score_matrices(model, engine, records, cache, maxsim_impl)
    if encode_passes > 1:
        # scores are deterministic; extra passes only re-time the encode
        times = [encoding_time]
        for _ in range(encode_passes - 1):
            times.append(compute_score_matrices(model, engine, records, cache, maxsim_impl)[2])
        encoding_time = float(np.median(times))
        logger.info(f"encode passes: {[round(t, 2) for t in times]} -> median {encoding_time:.2f}s")
    logger.info(f"Encoding+scoring completed in {encoding_time:.1f}s")
    report_memory(device)

    logger.info(f"Running {n_iterations} bootstrap iterations on device...")
    out = bootstrap_benchmark(s_t2i, s_i2t, n_iterations, seed=seed, caps_per_image=kc,
                              sample_idx=sample_idx)
    total_time = time.perf_counter() - t_start

    # random-weight runs must never be mistaken for accuracy parity
    aggregated: dict = {"Model": model.info.name, "Weights": model.weights_provenance}
    for key, values in out.metrics.items():
        mean, lower, upper = bootstrap_confidence_interval(values, idx=ci_idx)
        aggregated[f"{key}_mean"] = mean
        aggregated[f"{key}_lower"] = lower
        aggregated[f"{key}_upper"] = upper
        aggregated[f"{key}_std"] = float(np.std(values))

    aggregated["Time"] = total_time
    aggregated["QPS"] = n / encoding_time
    aggregated["Encoding_Time"] = encoding_time
    aggregated["Img_per_sec"] = n / encoding_time

    failure = aggregate_failure_analysis(out.correct_r1, out.sample_idx, [r["captions"][0] for r in records])
    aggregated["_failure_analysis"] = json.dumps(failure)
    aggregated["_bootstrap_metrics"] = dict(out.metrics)
    return aggregated


def _load(info, args, device) -> LoadedModel:
    if args.debug_models:
        return load_debug_model(info, seed=args.seed, device=device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.arch_models:
        from ..models.arch import load_arch_model

        return load_arch_model(info.name, seed=args.seed, device=device, dtype=dtype)
    return load_model(info, native_cache_dir=args.native_cache_dir, device=device, dtype=dtype)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging()
    _reject_unported(args)
    device = resolve_device(args.device)
    logger.info(f"BENCHMARK START (V29 STATISTICAL, PyTorch/CUDA) - Output: {args.output}")
    logger.info(f"Bootstrap iterations: {args.bootstrap_iterations}; device: {device}")

    from ..models.layers import set_attention_impl, set_layer_impl

    set_attention_impl(args.attention_impl)
    set_layer_impl(args.layer_impl)

    records = load_benchmark_dataset(
        args.dataset, cache_dir=args.cache_dir, workers=args.workers,
        sample_size=args.sample_size, seed=args.seed,
    )
    logger.info(f"Dataset: {len(records)} images, {caps_per_image(records) * len(records)} captions")

    cache: DeviceImageCache | None = None
    if args.device_cache:
        cache = stage_images([r["image"] for r in records], args.batch_size, device)
        logger.info(f"Staged {cache.n_images} raw images to {device} in {cache.stage_seconds:.1f}s "
                    f"(one-time, shared by all models)")

    final_results = []
    all_bootstrap: dict = {}
    for info in get_models_to_test(args.models, args.batch_size):
        logger.info("=" * 60)
        logger.info(f"EVALUATING: {info.name}")
        logger.info("=" * 60)
        if device.type == "cuda":  # each model's own peak
            torch.cuda.reset_peak_memory_stats(device)
        try:
            model = _load(info, args, device)
        except Exception as e:  # per-model skip-and-continue, as the reference
            logger.error(f"Model load failed: {e}")
            continue
        try:
            with maybe_trace(args.profile_dir and f"{args.profile_dir}/{info.name}"):
                result = run_bootstrap_benchmark(
                    model, records, args.bootstrap_iterations, device=device, batch_size=args.batch_size,
                    seed=args.seed, cache=cache, preprocess_impl=args.preprocess_impl,
                    maxsim_impl=args.maxsim_impl, encode_passes=args.encode_passes,
                )
            bootstrap_metrics = result.pop("_bootstrap_metrics", None)
            if bootstrap_metrics:
                all_bootstrap.update({f"{info.name}::{k}": v for k, v in bootstrap_metrics.items()})
                np.savez_compressed(args.output + ".bootstrap.npz", **all_bootstrap)
            final_results.append(result)
            pd.DataFrame(final_results).to_csv(args.output, index=False)
            logger.info(f"Checkpoint saved to {args.output}")
        except Exception as e:
            logger.error(f"Evaluation failed for {info.name}: {e}")
            traceback.print_exc()
        finally:
            # the engine, its preprocess weights and the model's activations
            # went with run_bootstrap_benchmark; this drops the weights, so
            # only the shared staged images stay on the device
            del model
            mem = device_memory_stats(device)
            logger.info(f"{info.name}: peak device memory {mem['peak_bytes_in_use'] / 1e9:.2f} GB; "
                        f"{mem['bytes_in_use'] / 1e9:.2f} GB in use after its release")

    logger.info("BENCHMARK COMPLETE!")
    logger.info(f"Results saved to {args.output}")
    if not final_results:
        logger.error("No model produced results — benchmark failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
