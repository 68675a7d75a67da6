"""V29-statistical benchmark CLI on one NVIDIA GPU.

Counterpart of ``multimodal_embedding_tpu/cli/main.py``: the same flags and
the same CSV schema, ``Model``, ``Weights``, ``{metric}_{mean,lower,upper,
std}`` for {T2I, I2T, I2T_Sym} x R@{1,5,10}, then ``Time``, ``QPS``,
``Encoding_Time``, ``Img_per_sec`` and ``_failure_analysis`` (reference
main.py:643-665). QPS = images / encode-phase seconds, where the encode
phase covers the images and both text sweeps (reference main.py:493-497);
warmup runs before the timer.

``--device`` picks the device: ``cuda`` (the default; ``cuda:LOCAL_RANK``
under torchrun), ``cuda:N`` (card N for every rank) or ``cpu``; without a
CUDA device the CLI exits nonzero unless ``--device cpu`` was given.

Parallelism (``parallel/``): launched by torchrun, the ranks form a
``(data, model)`` mesh, the model axis ``--tensor-parallel`` or
``--sequence-parallel`` (not both), the data axis the rest. Each data rank
encodes its rows of every batch, scores its query rows and runs its share
of the bootstrap iterations; tensor parallelism splits the towers' and
Gemma's weights over the model axis, sequence parallelism ColPali's Gemma
tokens. Only rank 0 writes the CSV, the bootstrap sidecar, the score cache
and the log; QPS is timed between barriers. In a world of one rank no
process group is made. Every rank must succeed: a model that fails on one
rank fails the run.

    torchrun --nproc-per-node 2 -m multimodal_embedding_tpu_torch.cli.main \\
        --device cpu --debug-models --tensor-parallel 2 --dataset synthetic

Staging (``--device-cache``, default on): with ``--overlap-staging`` (default)
a background thread stages the images while the first model loads and warms
up its text sweeps; the first model then joins the staging before its timed
encode and takes the same cached path as every later model, or, with
``--streaming-encode``, encodes each slice as it lands (its QPS then
excludes the upload stall). ``--score-cache-dir`` keeps each model's score
matrices and encode time, and a rerun on the same data reads them instead of
encoding.

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

from .. import runtime
from ..analysis.failure import aggregate_failure_analysis
from ..data.captions import caps_per_image
from ..data.coco import load_benchmark_dataset
from ..models.encode import AsyncImageStager, DeviceImageCache, EncodingEngine, stage_images
from ..models.registry import get_models_to_test
from ..models.zoo import LoadedModel, load_debug_model, load_model
from ..parallel.mesh import Mesh, barrier, distributed, get_mesh, is_writer, resolve_rank_device, world_size
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
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun), cuda:N (card N for "
                        "every rank) or, only when asked, cpu")
    p.add_argument("--maxsim-impl", type=str, default="auto", choices=["auto", "pallas", "xla"],
                   help="Multi-vector (ColPali) scoring: auto and pallas (the MaxSim "
                        "CUDA kernel on the card), or the plain PyTorch version (xla); "
                        "on the CPU always the plain version")
    p.add_argument("--transport", type=str, default="auto", choices=["auto", "host", "device"],
                   help="Image transport without --device-cache: on-device resize, host PIL "
                        "resize on threads, or auto (host below 1000 MB/s host->device)")
    p.add_argument("--device-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="Stage raw images to device memory once, shared across models")
    p.add_argument("--overlap-staging", action=argparse.BooleanOptionalAction, default=True,
                   help="Stage images in a background thread overlapped with "
                        "model 1's load + text warmup; model 1 joins staging "
                        "before its timed encode and measures the same cached "
                        "path as every other model")
    p.add_argument("--streaming-encode", action=argparse.BooleanOptionalAction, default=False,
                   help="With --overlap-staging: model 1 encodes slices as "
                        "they land instead of joining first (its timed encode "
                        "then measures the streaming path, upload stall excluded)")
    p.add_argument("--encode-passes", type=int, default=1,
                   help="Run the encode phase N times and report the median encoding_time/QPS")
    p.add_argument("--score-cache-dir", type=str, default=None,
                   help="Persist/resume encoded score matrices (skip re-encoding "
                        "on reruns of the same model+dataset)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Capture a torch.profiler trace of each model's benchmark; the trace carries the "
                        "port's mme.* ranges (encode sweeps, batches, tokenization, kernel calls), which cost "
                        "nothing when no profiler runs")
    p.add_argument("--attention-impl", type=str, default="auto",
                   choices=runtime.ATTENTION_IMPLS,
                   help="Tower self-attention: auto (the fused CUDA kernel on the "
                        "card, f32-logit SDPA on the CPU), f32-logit SDPA, "
                        "bf16-logit SDPA, the fused kernel ('pallas'), or 'flash' "
                        "(the fused kernel for unmasked self-attention, f32-logit "
                        "SDPA for the rest)")
    p.add_argument("--preprocess-impl", type=str, default="auto", choices=["auto", "xla", "pallas"],
                   help="Device preprocessing: auto (the CUDA kernel on the card, "
                        "plain matmuls on the CPU), plain matmuls, or the kernel ('pallas')")
    p.add_argument("--layer-impl", type=str, default="auto", choices=runtime.LAYER_IMPLS,
                   help="Encoder layer: auto and xla (plain ops), or fused (the "
                        "residual+LayerNorm+matmul prologue CUDA kernel feeding the "
                        "stacked-QKV attention kernel; their plain versions on the CPU)")
    p.add_argument("--native-cache-dir", type=str, default=None,
                   help="Keep the dense and siglip models' converted weights as .npz here "
                        "and reload them without transformers")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="Model-axis size of the device mesh: params are "
                        "Megatron column/row-split across this many chips "
                        "(parallel/tp.py); the data axis gets the rest")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="Model-axis size for sequence/context parallelism: "
                        "ColPali's 1030-token Gemma prefill shards its token "
                        "dim across this many chips (K/V all-gather, "
                        "parallel/sp.py). Mutually exclusive with "
                        "--tensor-parallel")
    return p.parse_args(argv)


def device_arg(name: str) -> str:
    """``--device``: cuda, cuda:N or cpu."""
    kind, _, index = name.partition(":")
    if name not in ("cuda", "cpu") and not (kind == "cuda" and index.isdigit()):
        raise argparse.ArgumentTypeError(f"--device takes cuda, cuda:N or cpu, not {name!r}")
    return name


def check_parallel_flags(args) -> None:
    """Tensor and sequence parallelism both take the model axis: one only."""
    if args.tensor_parallel > 1 and args.sequence_parallel > 1:
        raise SystemExit("--tensor-parallel and --sequence-parallel both use the model mesh axis; pick one")


def resolve_device(name: str) -> torch.device:
    """The device of a CLI with no parallel path (``cuda``, ``cuda:N`` or
    ``cpu``; ``parallel/mesh.py:resolve_rank_device``): no process group is
    joined. Never falls back from the card to the CPU."""
    return resolve_rank_device(name)


def data_mesh():
    """The companion CLIs' mesh: every rank on the data axis, as their JAX
    counterparts' ``get_mesh()``; None in a world of one."""
    return get_mesh() if world_size() > 1 else None


def compute_score_matrices(
    model: LoadedModel,
    engine: EncodingEngine,
    records: list[dict],
    cache: DeviceImageCache | None = None,
    maxsim_impl: str = "auto",
    stager: AsyncImageStager | None = None,
    mesh=None,
):
    """Encode once, build the two full score matrices. Returns
    (s_t2i [N,N], s_i2t [N,K*N], encoding_time). With a ``stager`` the images
    are encoded as their slices land, and the upload stall is not encode
    time. With a ``mesh`` of more than one rank the query rows are scored
    over its data axis, and the encode is timed between barriers."""
    kc = caps_per_image(records)
    t2i_captions = [r["captions"][0] for r in records]  # T2I uses the first caption
    all_captions = [c for r in records for c in r["captions"][:kc]]

    barrier(engine.device)
    t0 = time.perf_counter()
    stall = 0.0
    if stager is not None:
        img = engine.encode_images_streaming(stager)
        stall = (time.perf_counter() - t0) - img.seconds
    elif cache is not None:
        img = engine.encode_images_cached(cache)
    else:
        img = engine.encode_images([r["image"] for r in records])
    txt_t2i = engine.encode_texts(t2i_captions)
    txt_all = engine.encode_texts(all_captions)
    barrier(engine.device)
    encoding_time = time.perf_counter() - t0 - stall

    smesh = mesh if mesh is not None and mesh.size > 1 else None
    if model.multi_vector:
        # no masks: pad-token embeddings are exact zeros (COMPAT #8),
        # reproducing colpali_engine's scoring
        s_t2i = late_interaction_scores(txt_t2i.embeddings, img.embeddings, impl=maxsim_impl, mesh=smesh)
        s_i2t = late_interaction_scores(img.embeddings, txt_all.embeddings, impl=maxsim_impl, mesh=smesh)
    else:
        s_t2i = dense_scores(txt_t2i.embeddings, img.embeddings, mesh=smesh)
        s_i2t = dense_scores(img.embeddings, txt_all.embeddings, mesh=smesh)
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
    transport: str = "auto",
    score_cache_dir: str | None = None,
    stager: AsyncImageStager | None = None,
    streaming_encode: bool = False,
    sample_idx: np.ndarray | None = None,
    ci_idx: np.ndarray | None = None,
    mesh=None,
) -> dict:
    """Encode-once / resample-many (reference main.py:478-667). ``sample_idx``
    and ``ci_idx`` replay given bootstrap and CI resamples. With a
    ``stager`` (the first model of an overlapped run) the text sweeps warm
    up while uploads go on; then the staging is joined and the cached path
    runs, or, with ``streaming_encode``, the slices are encoded as they
    land. With ``score_cache_dir`` the score matrices and encode time come
    from an earlier run's file where one matches, else they are saved."""
    logger.info(f"Benchmarking {model.info.name} with {n_iterations} bootstrap iterations...")
    n = len(records)
    kc = caps_per_image(records)

    cached_scores = None
    if score_cache_dir:
        from ..stats.score_cache import load_scores

        cached_scores = load_scores(score_cache_dir, model.info.name, records, preprocess_impl, maxsim_impl,
                                    device=device)

    t_start = time.perf_counter()
    if cached_scores is not None:
        s_t2i, s_i2t, encoding_time = cached_scores
        s_t2i, s_i2t = torch.from_numpy(s_t2i).to(device), torch.from_numpy(s_i2t).to(device)
    else:
        engine = EncodingEngine(model, model.info.batch_size or batch_size, device=device,
                                preprocess_impl=preprocess_impl, transport=transport, mesh=mesh)
        logger.info("Warming up...")
        # the timed phase encodes two text sweeps; run both once first
        text_sets = [[r["captions"][0] for r in records], [c for r in records for c in r["captions"][:kc]]]
        if stager is not None and not streaming_encode:
            # warm the text sweeps while the uploads go on, then join the
            # staging before the timer and take the cached path: model 1's
            # QPS measures the same encode as every other model's
            engine.warmup(images=False, text_sets=text_sets)
            cache = stager.wait()
            stager = None
            logger.info(f"Background staging complete: {cache.n_images} images in {cache.stage_seconds:.1f}s "
                        f"(overlapped with model 1 load/text warmup)")
            engine.encode_images_cached(cache)
        elif stager is not None:
            engine.warmup_streaming(stager)
            engine.warmup(images=False, text_sets=text_sets)
        elif cache is not None:
            engine.encode_images_cached(cache)
            engine.warmup(images=False, text_sets=text_sets)
        else:
            for g in {r["image"].shape[:2] for r in records}:
                engine.warmup(g, text_sets=text_sets)

        t_start = time.perf_counter()
        s_t2i, s_i2t, encoding_time = compute_score_matrices(model, engine, records, cache, maxsim_impl, stager,
                                                             mesh)
        if encode_passes > 1:
            # scores are deterministic; extra passes only re-time the encode
            times = [encoding_time]
            extra_cache = cache if cache is not None else (stager.wait() if stager is not None else None)
            for _ in range(encode_passes - 1):
                times.append(compute_score_matrices(model, engine, records, extra_cache, maxsim_impl, mesh=mesh)[2])
            encoding_time = float(np.median(times))
            logger.info(f"encode passes: {[round(t, 2) for t in times]} -> median {encoding_time:.2f}s")
        if score_cache_dir and is_writer():
            from ..stats.score_cache import save_scores

            save_scores(score_cache_dir, model.info.name, records, s_t2i, s_i2t, encoding_time,
                        preprocess_impl, maxsim_impl, device=device)
    logger.info(f"Encoding+scoring completed in {encoding_time:.1f}s")
    report_memory(device)

    logger.info(f"Running {n_iterations} bootstrap iterations on device...")
    out = bootstrap_benchmark(s_t2i, s_i2t, n_iterations, seed=seed, caps_per_image=kc, sample_idx=sample_idx,
                              mesh=mesh if mesh is not None and mesh.size > 1 else None)
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


def load_model_for(info, *, debug: bool, arch: bool, seed: int, device, checkpoint_dir: str | None = None,
                   native_cache_dir: str | None = None) -> LoadedModel:
    """The model the CLIs run: random debug weights, random weights at the
    full published architecture, or the HF checkpoint; bf16 on the card, f32
    on the CPU."""
    if debug:
        return load_debug_model(info, seed=seed, device=device)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if arch:
        from ..models.arch import load_arch_model

        return load_arch_model(info.name, seed=seed, device=device, dtype=dtype)
    return load_model(info, device=device, dtype=dtype, checkpoint_dir=checkpoint_dir,
                      native_cache_dir=native_cache_dir)


def _load(info, args, device) -> LoadedModel:
    return load_model_for(info, debug=args.debug_models, arch=args.arch_models, seed=args.seed, device=device,
                          native_cache_dir=args.native_cache_dir)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_parallel_flags(args)
    tp, sp = args.tensor_parallel > 1, args.sequence_parallel > 1
    with distributed(args.device) as device:
        # rank 0 keeps the log; the other ranks print warnings and errors only
        setup_logging(**({} if is_writer() else {"log_file": None, "level": logging.WARNING}))
        logger.info(f"BENCHMARK START (V29 STATISTICAL, PyTorch/CUDA) - Output: {args.output}")
        logger.info(f"Bootstrap iterations: {args.bootstrap_iterations}; device: {device}")
        mesh = get_mesh(n_model=max(args.tensor_parallel, args.sequence_parallel))
        if mesh.size > 1:
            import torch.distributed as dist

            logger.info(f"Device mesh: {mesh.shape} over {mesh.size} ranks ({dist.get_backend()} backend), "
                        f"rank 0 on {device}")
        if sp:
            logger.info(f"--sequence-parallel {args.sequence_parallel}: ColPali's Gemma token dim sharded over "
                        f"the model axis (K/V all-gather)")
        if tp:
            logger.info("--tensor-parallel: attention kernel runs per-rank head shards; layer prologue fusion -> xla")
        # the attention kernel runs on each rank's heads; the residual+LN+matmul
        # prologue kernel does not split, so under TP the layer takes the plain path
        with runtime.using(attention=args.attention_impl, layer="xla" if tp else args.layer_impl,
                           tp=mesh if tp else None, sp=mesh if sp else None):
            return _run(args, device, mesh)


def _run(args, device: torch.device, mesh: Mesh) -> int:
    records = load_benchmark_dataset(
        args.dataset, cache_dir=args.cache_dir, workers=args.workers,
        sample_size=args.sample_size, seed=args.seed,
    )
    logger.info(f"Dataset: {len(records)} images, {caps_per_image(records) * len(records)} captions")

    cache: DeviceImageCache | None = None
    stager: AsyncImageStager | None = None
    if args.device_cache:
        images = [r["image"] for r in records]
        if args.overlap_staging:
            stager = AsyncImageStager(images, args.batch_size, device, mesh)
            mode = ("model 1 encodes streaming slices" if args.streaming_encode
                    else "model 1 joins before its timed encode")
            logger.info(f"Staging {stager.n_images} raw images to {device} in the background "
                        f"({len(stager.slice_plan)} slices) — {mode}")
        else:
            cache = stage_images(images, args.batch_size, device, mesh)
            logger.info(f"Staged {cache.n_images} raw images to {device} in {cache.stage_seconds:.1f}s "
                        f"(one-time, shared by all models)")

    final_results = []
    all_bootstrap: dict = {}
    stager_used = False
    for info in get_models_to_test(args.models, args.batch_size):
        logger.info("=" * 60)
        logger.info(f"EVALUATING: {info.name}")
        logger.info("=" * 60)
        this_stager = None
        if stager is not None:
            if not stager_used:
                this_stager = stager
                stager_used = True
            else:
                # later models take the assembled cache; a staging failure
                # follows the per-model skip-and-continue policy
                try:
                    cache = stager.wait()
                    logger.info(f"Background staging complete: {cache.n_images} images in "
                                f"{cache.stage_seconds:.1f}s (overlapped with model 1)")
                except Exception as e:  # the run goes on without the shared device cache
                    if world_size() > 1:
                        raise
                    logger.error(f"Background staging failed: {e} — continuing without the shared device cache")
                    cache = None
                finally:
                    stager = None
        if device.type == "cuda":  # each model's own peak
            torch.cuda.reset_peak_memory_stats(device)
        try:
            model = _load(info, args, device)
        except Exception as e:  # per-model skip-and-continue, as the reference
            if world_size() > 1:  # the ranks' collectives would part ways
                raise
            logger.error(f"Model load failed: {e}")
            continue
        try:
            with maybe_trace(args.profile_dir and f"{args.profile_dir}/{info.name}"):
                result = run_bootstrap_benchmark(
                    model, records, args.bootstrap_iterations, device=device, batch_size=args.batch_size,
                    seed=args.seed, cache=cache, preprocess_impl=args.preprocess_impl,
                    maxsim_impl=args.maxsim_impl, encode_passes=args.encode_passes, transport=args.transport,
                    score_cache_dir=args.score_cache_dir, stager=this_stager,
                    streaming_encode=args.streaming_encode, mesh=mesh,
                )
            bootstrap_metrics = result.pop("_bootstrap_metrics", None)
            if bootstrap_metrics:
                all_bootstrap.update({f"{info.name}::{k}": v for k, v in bootstrap_metrics.items()})
                if is_writer():  # the raw per-iteration samples: the analyzer's permutation tests read them
                    np.savez_compressed(args.output + ".bootstrap.npz", **all_bootstrap)
            final_results.append(result)
            if is_writer():
                pd.DataFrame(final_results).to_csv(args.output, index=False)
                logger.info(f"Checkpoint saved to {args.output}")
        except Exception as e:
            if world_size() > 1:
                raise
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

    if stager is not None and stager_used:
        # a one-model run (or a failed first model): join the staging thread
        # so no upload is in flight when the process exits
        try:
            stager.wait()
        except Exception as e:  # the results are written; report the staging failure
            if world_size() > 1:
                raise
            logger.error(f"Background staging failed after results: {e}")

    logger.info("BENCHMARK COMPLETE!")
    logger.info(f"Results saved to {args.output}")
    if not final_results:
        logger.error("No model produced results — benchmark failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
