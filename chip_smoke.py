#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --cases maxsim,preprocess    # the build and these phase-2 cases only
                                                      # (sets: activation, attention, attention_qkv,
                                                      # maxsim, moe_glue, prologue, layernorm, preprocess,
                                                      # ssm, kda)
    python3 chip_smoke.py --attention-cases            # the same as --cases attention

Phases, each of which fails the run (nonzero exit, no result line):
  1. build the CUDA kernels of ``multimodal_embedding_tpu_torch/csrc`` (one
     nvcc per source, all at once) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (OpenAI-CLIP-L, ColPali-v1.3 and the fused encoder
     layer's; the ViT-H and SigLIP-So400m towers, the MAP head's one probe
     row over 729 keys, and the four other models' preprocess recipes; the
     left-padded causal prefills of Qwen3-14B and the small Qwen3, and
     Qwen3-14B's GRPO forward over a group of 8 at 272 tokens, with the
     attention Function's q/k/v grads there against plain f32 autograd; one
     rank's ViT-L heads under ``--tensor-parallel 2``, ``[64,577,8x64]``, and
     the shapes phase 10 launches a rank (``[32,577,8x64]``, the text shard
     ``[128,77,6x64]`` causal with a mask; under data parallelism
     ``[16,577,16x64]`` and ``[64,77,12x64]``); one rank's Qwen3-14B heads
     under tensor parallelism 2, ``[8,272,20x128]`` and ``[8,224,20x128]``
     over 4 KV heads, causal and left-padded (phase 11's passes); plus
     attention at a 4096-key row, and MaxSim at a fifth of COCO-5k's I2T,
     checked on its first 64 queries; the f32 kernels at their paths' shapes:
     Qwen3-14B's heads in f32 ``[64,256,40x128]`` (an f32 ``--save-base``
     base under ``cli/verify_rl.py``), an f32 4096-key row, f32 stacked QKV
     ``[64,577,3072]``, and MaxSim on a search-sized f32 index, 64 queries of
     32 tokens against ``[5000,1030,128]``, checked on its first 4 queries;
     each f32 case also prints its 3xTF32 bound, its TFLOP/s and SDPA's
     device time; and phase 13's ``entry()`` shapes, ViT-L ``[8,577,16x64]``
     and the b8 480x640 preprocess; the MLP activation at fc1's output in the
     benchmark cells' towers, ViT-L b32, CLIP text b128, So400m b32 and
     SigLIP text b128, at ViT-H b32 and on a ragged f32 tensor, each beside
     its plain composition and, for the GELUs, ``F.gelu``; the MoE layer's
     SwiGLU and combine kernels at a Kimi-VL-A3B page batch, the routed,
     shared and dense SwiGLU and the combine with its addend, each beside
     the ATen chain it replaced, with ``index_put`` and the gather of the
     routed rows timed alone, and a ``ColPali-KimiVL-A3B`` caption batch at
     full width whose CUDA graph replays are bit-equal to the eager forward
     and add its launch counts, 53 and 26, each call's counts set to 0 just
     before it; the combine at top-10 of 72 experts and width 4096, its
     16-choice build; the Mamba-2 scan kernel at Granite-4.0-H-Small's
     widths against its plain chunked version, at the Granite cell's page
     batch and its two caption batches (the chunked body), a ragged f32 one
     (the recurrent body) and two pages of decays near 1, with its device
     time against the recurrence's bound, and a ``ColPali-Granite-4.0-H-Small``
     page batch and caption batch at full width, each forward 36 ``ssm_scan``
     (36 ``ssm_scan_chunked``), 80 ``moe_swiglu`` and 40 ``moe_combine``, the
     caption batch's graph replays bit-equal to its eager forward); the KDA
     kernel at Kimi-Linear-48B-A3B's widths against its plain chunked
     version, at the Kimi-Linear cell's page batch and its two caption
     batches and a ragged f32 one, with its device time against the
     recurrence's bound, and a ``ColPali-Kimi-Linear-48B-A3B`` page batch
     and caption batch at full width, each forward 12 ``kda_scan``, 31
     ``moe_swiglu`` and 15 ``moe_combine``, the
     caption batch's graph replays bit-equal to its eager forward),
     with the tolerances stated below, and time both, the one
     PyTorch library call that computes the same function (where there is
     one) and the least time the card could take (``bound_ms``), and each
     kernel's device time alone (``device_ms``) beside the library call's
     (``library_device_ms``; for the prologue, ``addmm`` for orientation),
     with the prologue's row pass also timed alone (``row_device_ms``);
  3. the main paths at full width, each through the port's CLI in-process
     on the synthetic dataset at the model's published architecture with
     random weights: OpenAI-CLIP-L (dense), ColPali-v1.3 (multi-vector,
     MaxSim scoring), then OpenAI-CLIP-L again under ``--layer-impl fused``
     (the prologue and stacked-QKV attention kernels in every encoder layer),
     then the other five benchmark models in one CLI run (LAION-CLIP-H,
     MetaCLIP-H14, Apple-DFN5B-H, SigLIP-400M, Jina-CLIP-v1; 128 images, 100
     bootstrap iterations), each model's weights released before the next
     loads, then ColPali-KimiVL-A3B (the MoE decoder: 16 pages, 20 bootstrap
     iterations; 53 ``moe_swiglu`` and 26 ``moe_combine`` launches a decoder
     forward, none on any other path); each model's launch counts are set to 0 just before its
     benchmark and read just after, every kernel of its path must have
     launched (Jina's towers have no attention kernel route: preprocess
     only), and its QPS and peak device memory are printed;
  4. the port bench's line (``multimodal_embedding_tpu_torch/bench.py:run_once``:
     288 images of 480x640, batch 96, three timed passes from the staged cache);
  5. full-width consistency: CLS embeddings of 8 images through the kernels
     in bf16, under both layer impls and ``--attention-impl flash``, against
     the plain versions in f32, per-row cosine >= 0.999; ColPali per-token embeddings of 2 images and 4
     captions, the same way, per-token cosine >= 0.99 over valid tokens and
     exact-zero pad tokens; pooled embeddings of 8 images and 8 captions of
     each of the other five models, the same way (ViT-H and SigLIP under both
     layer impls, Jina on its own path), per-row cosine >= 0.999;
  6. converted checkpoints at full width: an HF-layout state dict of
     OpenAI-CLIP-L, SigLIP-400M, ColPali-v1.3 and Jina-CLIP-v1 (the keys and
     shapes of ``tests/manifests``, seeded values made key by key)
     through the port's converters and loaders, with the conversion and load
     seconds and each model's peak device memory; pooled embeddings of 8
     images and 8 captions through the kernels in bf16 (CLIP-L and SigLIP
     under both layer impls) against the plain versions in f32 on the f32
     weights, per-row cosine >= 0.999 (ColPali: per-token cosine >= 0.99 and
     mean >= 0.999, its MaxSim scores through the kernel); CLIP-L's and
     SigLIP-400M's trees written with ``save_params`` and reloaded give
     bit-equal embeddings; the CLI with ``--native-cache-dir`` and neither
     debug flag scores both models from that cache (``Weights`` = real);
  7. the rest of Workload A at full width (arch-random weights, synthetic
     data): the stager on the engine (256 records, 4 geometries: streaming
     embeddings and the assembled cache bit-equal to the cached path's, the
     upload stall), host against device transport on 32 images (pooled cosine
     >= 0.999, pixels within one uint8 level of PIL's); the CLI for
     OpenAI-CLIP-L (256 images) with ``--overlap-staging`` (the default; it
     also writes ``--score-cache-dir``), ``--streaming-encode``, ``--transport
     host --no-device-cache`` (no preprocess launch), ``--attention-impl flash``
     (fewer attention launches: the masked text tower takes the plain path),
     then a rerun from the score cache (the same metrics, no launch);
     ``cli/multi_seed.py`` for OpenAI-CLIP-L and ColPali-v1.3 (128 images, 2
     runs, synthetic Winoground: attention, preprocess and MaxSim launched,
     finite scores, every R@K and Winoground % in [0, 100]);
     ``cli/encode_cli.py`` then ``cli/search.py`` on a ColPali index (f32: the
     f32 MaxSim kernel launched, top-10 ids equal to the plain path's);
     ``cli/probe.py --weights arch`` for OpenAI-CLIP-L and ColPali-v1.3; and
     ``cli/analyze.py`` on phase 3's five-model CSV and bootstrap sidecar
     (permutation p-values in [0, 1]; multi_seed writes no sidecar).

  8. Workload B serving (arch-random, bf16, seeded CUDA generators):
     Qwen3-14B (``QWEN3_14B``) at full width cut to 4 layers, the prefill's
     hidden states at valid positions and the first-token logits through the
     kernels in bf16 against the plain attention path in f32, per-row cosine
     >= 0.999; then all 40 layers through ``rl.verify.evaluate_merged`` (128
     synthetic support tickets, batch 64, prompts left-padded to 256, 48
     greedy tokens; LoRA adapters from ``lora_init`` with ``b`` drawn at std
     0.02): the attention kernel launched 40 times a ``generate`` and never
     while decoding, every rate in [0, 100], with the prefill ms, the decode
     ms a step, a step alone (``ms`` and ``device_ms``, beside its bound,
     and its host time by op from torch.profiler),
     decode tokens/s and peak device memory; then the same merged weights on
     the plain attention path for the first batch (the share of equal greedy
     tokens; first-token logit cosine >= 0.99 a row); and
     ``cli/verify_rl.py`` for ``--arch qwen3`` and ``--arch gemma`` at
     ``--model-size small --baseline --dataset-size 16`` with an adapters
     ``.npz`` the phase writes (the stats line parses, each rate in [0, 100],
     the attention kernel launched).
  9. Workload B training (arch-random, bf16, seeded CUDA generators):
     Qwen3-14B at full width cut to 4 layers, one GRPO ``loss_and_grads`` on
     a rollout of a support ticket with advantages +-1, the kernels in bf16
     against the plain attention path on the f32 weights (each adapter
     gradient's cosine >= 0.99; loss, pg and kl within 5%); then all 40 layers
     through ``GRPOTrainer.train`` (4 tickets, a group of 8, 48 new tokens,
     grad-accum 2: 2 AdamW steps; ``b`` drawn at std 0.02, so the KL term
     moves the adapters under the random policy's flat rewards): the adapters
     moved, loss and kl finite, 40 attention launches in each prompt's
     rollout prefill, reference pass and loss pass, each part's seconds and
     the peak device memory; and ``cli/train_rl.py --model-size small
     --format-pretrain 20 --save-base`` then ``cli/verify_rl.py`` on its base
     and adapters, for Qwen3 and Gemma (the stats parse, each rate in [0, 100],
     the attention kernel launched in both).
 10. two ranks sharing the one card through gloo (``--device cuda:0``), started
     by torchrun as this script with ``--parallel-rank`` (the kernels built by
     phase 1): ``cli/main.py --tensor-parallel 2`` on OpenAI-CLIP-L at full
     width (128 images, batch 32; pooled image and text cosine >= 0.999
     against one rank's kernels, one CSV with every R@K in [0, 100], 24
     attention launches a rank per image batch at ``[32,577,8x64]`` and 12 per
     text batch at ``[128,77,6x64]``); the same model under plain data
     parallelism (cosine >= 0.9999, the bootstrap bit-equal to one rank's on
     the same scores); ``--sequence-parallel 2`` on ColPali-v1.3 at full width
     through the engine, 8 images and 16 queries (per-token cosine >= 0.99 min
     and >= 0.999 mean against one rank, pads exact zeros, MaxSim scores
     finite); each rank's launches, peak device memory and seconds. Its QPS is
     two processes time-slicing one card with collectives through host
     memory, not a scaling figure.
 11. Workload B on a (data, model) mesh, two ranks sharing the card through
     gloo, started by torchrun as this script with ``--grpo-rank``: one
     ``GRPOTrainer`` step of Qwen3-14B at full width and all 40 layers split
     over the two ranks (arch-random, bf16, LoRA rank 16 with ``b`` drawn at
     std 0.02; one support ticket bucketed to 224 tokens, a group of 8, 48
     sampled tokens; each rank's weights drawn on the card a layer at a time
     and split as they come): each part's seconds, the peak device memory a
     rank, 40 attention launches in each pass a rank at ``[8,224,20x128]``
     (the rollout prefill) and ``[8,272,20x128]`` (the reference and loss
     passes), the adapters bit-equal on both ranks after the step, loss and
     kl finite; then the same model cut to 4 layers, one ``loss_and_grads``
     split over the ranks against one rank alone on the same weights,
     adapters and completions (each adapter gradient's cosine >= 0.999; loss,
     pg and kl within 2%; the greedy rollout of 8 tickets, its token equal to
     one rank's in >= 90% of positions, each fed one rank's tokens before it;
     the free-running share and one rank's own flips beside it) and, on the
     f32 weights, on half the group a rank (cosine >= 0.99999, loss within
     1e-4; the same in bf16 reported beside it), each side's adapters
     bit-equal across the ranks after AdamW;
     finally ``dryrun_multichip(2)`` on the card (rank 0's launches: 28 f32
     attention, 2 f32 MaxSim, 4 preprocess). Two processes time-slice
     one card with collectives through host memory: not a scaling figure.
 12. the f32 kernels' paths at full width: ``retrieval/search.Index`` on a
     COCO-5k-sized f32 ColPali index (seeded, token-normalized embeddings
     made on the card, ``[5000,1030,128]``), 64 queries of 32 tokens at
     k = 10, searched twice (the same answer; one f32 MaxSim launch each),
     the first 4 queries' top-10 ids equal to the plain path's and their
     scores within 1e-5 relative, the search's seconds; then Qwen3-14B cut
     to 4 layers at full width in f32 (arch-random) through the prefill and
     ``rl/generate.py:generate`` at batch 64, prompts left-padded to 256, 8
     greedy tokens, on the f32 attention kernel against the plain attention
     path (hidden states at valid positions and first-token logits per-row
     cosine >= 0.99999, greedy tokens equal, 4 launches in each prefill and
     none while decoding), the prefill's ms.
 13. the contract's forward step: ``entry()`` with no arguments (full-width
     OpenAI-CLIP-L in bf16, its 8 example images of 480x640 on the card),
     ``fn(*args)`` once with its launches counted (1 preprocess, 24
     attention, no other) and 10 times under CUDA events: ``ms``,
     ``device_ms``, img/s, peak device memory; its embeddings against the
     plain preprocess and the ``xla`` attention on the same weights in f32,
     per-image cosine >= 0.9999.

The last three lines are the kernels' JSON line (``flash_sdpa``, the
``--attention-impl flash`` route, runs the attention kernel: its numbers are
``fused_attention``'s ViT-L case, its launches phase 7's flash run;
``fused_attention_f32`` and ``maxsim_f32`` are the f32 bodies of the two
sources, their launches phase 12's; ``ops.launch_counts`` counts each launch
under one name), the
card's name and power limit, and ``{"ok": true, "device": {...}}``. Imports only the port, the
benchmark's yardstick (``perfbench/yardstick.py``: the card's peaks and ``bound_s``), torch and
numpy.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from collections.abc import Mapping
from pathlib import Path

import numpy as np

from perfbench.yardstick import PEAKS, bound_s

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# The H100 SXM peaks of the benchmark's yardstick, and f32 products as three
# TF32 tensor-core products (3xTF32, the f32 attention and MaxSim kernels): a
# third of the dense TF32 peak
H100 = {**PEAKS["H100"], "tf32x3_flops": PEAKS["H100"]["tf32_flops"] / 3}

ATTN_TOL_BF16 = 2e-2  # bf16 kernel vs the f32 plain version on the same bf16 inputs
ATTN_TOL_F32 = 1e-5
# Relative limits, max|d|/max|plain| and mean|d|/mean|plain|. Rounding p and
# the output to bf16 gives about 0.4% and 0.2% at the ViT-L and text shapes;
# one valid key dropped from each row gives about 26% and 2.5% at ViT-L, which
# the absolute limit alone need not see where outputs are small.
ATTN_REL_TOL_BF16 = 1e-2
ATTN_REL_TOL_F32 = 1e-5
# The attention Function's q/k/v grads (bf16, recomputed through the plain
# version) against autograd of the plain version in f32, max|d|/max|plain| and
# mean|d|/mean|plain|: rounding p, dP and the grads to bf16 gives about 0.5%
# and 0.3% at [2, 272, 10x128] on the CPU.
ATTN_GRAD_REL_TOL_BF16 = 2e-2
PRE_MIN_BIT_EQUAL = 0.999  # fraction of output elements bit-equal to the plain version
# MaxSim, max|d|/max|plain| against the f32 plain version on the same inputs:
# bf16 products are exact in f32, so only the order of the f32 sums differs.
MAXSIM_REL_TOL_BF16 = 1e-4
MAXSIM_REL_TOL_F32 = 1e-5
# The prologue kernel: x_new bit-equal to the plain version in the same dtype;
# y against the plain version in f32 on the same inputs, max|d|/max|plain| and
# mean|d|/mean|plain| (rounding h and y to bf16 gives about 0.4%).
PROLOGUE_REL_TOL_BF16 = 1e-2
PROLOGUE_REL_TOL_F32 = 1e-5
LN_REL_TOL_BF16 = 1e-2  # LayerNorm, the same relative limits against f32
LN_REL_TOL_F32 = 1e-5
# the MLP activation against the plain version in the same dtype: within one
# ulp (two in f32), bit-equal on at least this share of the elements
ACT_MIN_BIT_EQUAL = 0.999
COSINE_MIN = 0.999
# ColPali per-token cosine, kernels in bf16 vs plain versions in f32: 27
# SigLIP and 18 Gemma layers of bf16 rounding at full width.
COLPALI_COSINE_MIN = 0.99
# a search at COCO-5k size (phases 2 and 12): 64 queries of 32 tokens against
# 5000 ColPali images of 1030 tokens, f32 as encode_cli writes them
SEARCH_QUERIES_N, SEARCH_DOCS = 64, 5000

CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "OpenAI-CLIP-L",
    "--sample-size", "512", "--bootstrap-iterations", "200", "--batch-size", "64",
]
COLPALI_CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "ColPali-v1.3",
    "--sample-size", "128", "--bootstrap-iterations", "100",
]
# the other five benchmark models in one CLI run (registry batch: 32 images)
OTHER_MODELS = ("LAION-CLIP-H", "MetaCLIP-H14", "Apple-DFN5B-H", "SigLIP-400M", "Jina-CLIP-v1")
OTHER_CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", ",".join(OTHER_MODELS),
    "--sample-size", "128", "--bootstrap-iterations", "100",
]
# the DeepSeek ColPali (a MoE decoder: the MoE SwiGLU and combine kernels'
# path), batch 8 pages
KIMI_CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "ColPali-KimiVL-A3B",
    "--sample-size", "16", "--bootstrap-iterations", "20",
]
# phase 6: HF-layout checkpoints at full width, converted by the port
CONVERTED_MODELS = ("OpenAI-CLIP-L", "SigLIP-400M", "ColPali-v1.3", "Jina-CLIP-v1")
CACHED_MODELS = ("OpenAI-CLIP-L", "SigLIP-400M")  # the native cache: dense and siglip models
REAL_CLI_ARGS = [
    "--dataset", "synthetic", "--models", ",".join(CACHED_MODELS),
    "--sample-size", "128", "--bootstrap-iterations", "100",
]
MANIFESTS = ROOT / "tests" / "manifests"
NORMAL_POOL = 536_870_909  # a prime above ColPali's largest key, its 257216 x 2048 embedding table
COLPALI_SUFFIX_IDS = np.array([2, 10, 11, 12, 13, 14], np.int32)  # a 6-token image prompt suffix
REFERENCE_COLUMNS = (
    ["Model", "Weights"]
    + [f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
       for s in ("mean", "lower", "upper", "std")]
    + ["Time", "QPS", "Encoding_Time", "Img_per_sec", "_failure_analysis"]
)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, flops_key: str) -> tuple[float, str]:
    """``yardstick.bound_s`` in milliseconds at the ``H100[flops_key]`` rate,
    and which of the two it is bound by."""
    by = "operations" if flops / H100[flops_key] >= nbytes / H100["bytes"] else "bytes"
    return 1e3 * bound_s(flops, nbytes, H100, flops_key), by


def attention_launches() -> int:
    """The attention kernel's launches so far, both bodies (``ops.launch_counts``)."""
    from multimodal_embedding_tpu_torch.ops import launch_counts

    counts = launch_counts()
    return counts["fused_attention"] + counts["fused_attention_f32"]


def device_ms(fn, iters: int = 10, windows: int = 3, tries: int = 6) -> float | None:
    """Mean device time of the kernels ``fn`` launches per call, from
    torch.profiler windows of ``iters`` calls: what ``ms`` reads less the
    host's time before the launch, which dominates calls under about 0.2 ms.
    CUPTI now and then hands back a window with no kernel record in it, or
    with only some of them (it then reads low): the result is the median of
    ``windows`` windows that hold a record, each empty one taken again, up to
    ``tries`` windows in all. With none, the time is None ("not measured")
    and a note is printed."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            times.append(total_us / iters / 1e3)
            if len(times) == windows:
                break
    if not times:
        print(f"[device_ms] not measured: the profiler saw no kernel record in {tries} windows")
        return None
    return statistics.median(times)


# --- phase 1 -------------------------------------------------------------------


def phase_build() -> float:
    from multimodal_embedding_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built in {dt:.1f} s")
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


# --- phase 2 -------------------------------------------------------------------


def _attention_case(name, *, b, h, kvh, t, dh, dtype, causal, masked, layout, full_mask_rows, rng, tq=None,
                    left_padded=False):
    """``tq`` query rows (default ``t``) against ``t`` keys; ``left_padded``
    keeps each sequence's valid keys at its end (a generation prefill), so
    under ``causal`` every pad query row is fully masked."""
    import torch
    import torch.nn.functional as F

    from multimodal_embedding_tpu_torch.ops import attention_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    tq = t if tq is None else tq

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    if layout == "packed":
        q, k, v = rand((b, tq, h * dh)), rand((b, t, kvh * dh)), rand((b, t, kvh * dh))
    else:
        q, k, v = rand((b, h, tq, dh)), rand((b, kvh, t, dh)), rand((b, kvh, t, dh))
    km = None
    if masked:
        lengths = rng.integers(3, t + 1, size=b)
        if left_padded:
            km_np = (np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)
        else:
            km_np = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
        if full_mask_rows:
            km_np[-1] = 0  # every query row of the last sequence is fully masked
            km_np[0, 0] = 0  # with causal, query row 0 of sequence 0 is fully masked
        km = torch.from_numpy(km_np).to(dev)
    kw = dict(causal=causal, layout=layout, num_heads=h, num_kv_heads=kvh)
    valid = torch.ones(b, 1, tq, t, dtype=torch.bool, device=dev)
    if km is not None:
        valid = valid & km.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(tq, t, dtype=torch.bool, device=dev).tril()

    out = attention_cuda.fused_attention(q, k, v, km, **kw)
    torch.cuda.synchronize()
    scale = 1.0 / math.sqrt(dh)
    plain = attention_cuda._plain(q.float(), k.float(), v.float(), km, causal, scale, layout, h, kvh)
    diff = (out.float() - plain).abs()
    err = float(diff.max())
    max_rel = err / float(plain.abs().max())
    mean_rel = float(diff.mean()) / float(plain.abs().mean())
    bf16 = dtype == torch.bfloat16
    tol, rel_tol = (ATTN_TOL_BF16, ATTN_REL_TOL_BF16) if bf16 else (ATTN_TOL_F32, ATTN_REL_TOL_F32)
    require(math.isfinite(err) and err <= tol, f"attention {name}: max abs err {err} > {tol}")
    require(max_rel <= rel_tol and mean_rel <= rel_tol,
            f"attention {name}: relative err max {max_rel}, mean {mean_rel} > {rel_tol}")
    if full_mask_rows:
        o4 = out if layout == "bhtd" else out.reshape(b, tq, h, dh).transpose(1, 2)
        require(bool((o4[-1] == 0).all()), f"attention {name}: fully masked sequence not exact zeros")
        if causal:
            require(bool((o4[0, :, 0] == 0).all()), f"attention {name}: fully masked row not exact zeros")
        dead = ~valid[:, 0].any(-1)  # [B, Tq]: every fully masked query row (all pad rows when left-padded)
        require(bool((o4.transpose(1, 2)[dead] == 0).all()),
                f"attention {name}: {int(dead.sum())} fully masked rows not all exact zeros")

    ms = cuda_time_ms(lambda: attention_cuda.fused_attention(q, k, v, km, **kw))
    dev_ms = device_ms(lambda: attention_cuda.fused_attention(q, k, v, km, **kw))
    plain_ms = cuda_time_ms(lambda: attention_cuda._plain(q, k, v, km, causal, scale, layout, h, kvh))

    def bhtd(x, nh, n):
        return x if layout == "bhtd" else x.reshape(b, n, nh, dh).transpose(1, 2)

    q4, k4, v4 = bhtd(q, h, tq), bhtd(k, kvh, t), bhtd(v, kvh, t)
    if kvh != h:  # SDPA's GQA: K/V expanded outside the timed call
        k4, v4 = k4.repeat_interleave(h // kvh, 1), v4.repeat_interleave(h // kvh, 1)
    attn_mask = valid if (masked or causal) else None

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)

    library_ms = cuda_time_ms(sdpa)

    es = q.element_size()
    wgmma = attention_cuda.uses_wgmma(dtype, dh)
    pairs = float(valid.sum()) * h  # (batch, head, query, key) pairs the function needs
    flops = 4.0 * pairs * dh
    nbytes = es * dh * (2 * b * tq * h + 2 * b * t * kvh) + (b * t if km is not None else 0)
    bms, by = bound_ms(flops, nbytes, "bf16_flops" if dtype == torch.bfloat16 else "f32_flops")
    case = {"case": name, "shape": [b, h, kvh, t, dh], "queries": tq, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by, "tflops": flops / (ms * 1e9), "device_ms": dev_ms,
            "body": "wgmma" if wgmma else ("mma.sync" if bf16 else "3xtf32")}
    if bf16:  # SDPA's device time beside the kernel's, the table's yardstick
        case["library_device_ms"] = device_ms(sdpa)
        case["bound_pct"] = None if dev_ms is None else 100.0 * bms / dev_ms
    else:
        case.update(_f32_extras(flops, nbytes, dev_ms, sdpa))
    print(f"[attention] {json.dumps(case)}")
    return case


def _f32_extras(flops: float, nbytes: float, dev_ms, library) -> dict:
    """An f32 case's two halves of its bound (the operations this case's
    masks leave over the f32 peak; the bytes), its 3xTF32 bound (the
    operations over a third of the TF32 peak, or the bytes), its TFLOP/s on
    the device, and the library call's device time."""
    return {"ops_ms": 1e3 * flops / H100["f32_flops"], "bytes_ms": 1e3 * nbytes / H100["bytes"],
            "bound_3xtf32_ms": bound_ms(flops, nbytes, "tf32x3_flops")[0],
            "device_tflops": None if dev_ms is None else flops / (dev_ms * 1e9),
            "library_device_ms": device_ms(library)}


def _attention_grad_case(name, *, b, h, kvh, t, dh, rng):
    """The attention Function's backward at a training shape (bf16, packed,
    causal, left-padded key mask): its q, k and v grads against autograd of
    the plain version in f32 on the same inputs and output grad, with
    max|d|/max|plain| and mean|d|/mean|plain| each within
    ``ATTN_GRAD_REL_TOL_BF16``; then the forward and backward's time through
    the Function beside the plain version's autograd in bf16."""
    import torch

    from multimodal_embedding_tpu_torch.ops import attention_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, bf16)

    q, k, v, g = rand((b, t, h * dh)), rand((b, t, kvh * dh)), rand((b, t, kvh * dh)), rand((b, t, h * dh))
    lengths = rng.integers(t // 2, t + 1, size=b)
    km = torch.from_numpy((np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)).to(dev)
    scale = 1.0 / math.sqrt(dh)

    def kernel_grads():
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        out = attention_cuda.fused_attention(*qkv, km, causal=True, layout="packed", num_heads=h, num_kv_heads=kvh)
        return torch.autograd.grad(out, qkv, g)

    def plain_grads(dtype):
        qkv = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        out = attention_cuda._plain(*qkv, km, True, scale, "packed", h, kvh)
        return torch.autograd.grad(out, qkv, g.to(dtype))

    got, want = kernel_grads(), plain_grads(torch.float32)
    errs = {}
    for x, a, w in zip("qkv", got, want):
        d = (a.float() - w).abs()
        max_rel, mean_rel = float(d.max()) / float(w.abs().max()), float(d.mean()) / float(w.abs().mean())
        require(a.dtype == bf16 and math.isfinite(max_rel) and max_rel <= ATTN_GRAD_REL_TOL_BF16
                and mean_rel <= ATTN_GRAD_REL_TOL_BF16,
                f"attention grad {name}: d{x} relative err max {max_rel}, mean {mean_rel} > {ATTN_GRAD_REL_TOL_BF16}")
        errs[f"d{x}"] = [max_rel, mean_rel]
    case = {"case": name, "shape": [b, h, kvh, t, dh], "dtype": "bfloat16", "grad_rel_err": errs,
            "fwd_bwd_ms": cuda_time_ms(kernel_grads), "plain_fwd_bwd_ms": cuda_time_ms(lambda: plain_grads(bf16))}
    print(f"[attention] {json.dumps(case)}")
    return case


def _preprocess_case(name, *, h, w, b, model="OpenAI-CLIP-L", rng):
    import torch

    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn, scale_shift
    from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn, preprocess_weights
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    cfg = model_info(model).preprocess
    c = cfg.image_size
    x = torch.from_numpy(rng.integers(0, 256, size=(b, 3, h, w), dtype=np.uint8)).cuda()
    kern = make_preprocess_cuda_fn(cfg, h, w, device="cuda")
    plain = make_preprocess_fn(cfg, h, w, device="cuda", input_format="nchw")
    out, ref = kern(x), plain(x)
    torch.cuda.synchronize()
    bit_equal = float((out == ref).float().mean())
    diff = (out - ref).abs()
    level = scale_shift(cfg)[0]
    per_ch = [float(diff[..., ch].max()) for ch in range(3)]
    require(bit_equal >= PRE_MIN_BIT_EQUAL, f"preprocess {h}x{w}: bit-equal {bit_equal} < {PRE_MIN_BIT_EQUAL}")
    for ch in range(3):
        lim = float(level[ch]) * (1 + 1e-5) + 1e-6
        require(per_ch[ch] <= lim, f"preprocess {h}x{w} channel {ch}: max diff {per_ch[ch]} > one level {lim}")
    ms = cuda_time_ms(lambda: kern(x))
    dev_ms = device_ms(lambda: kern(x))
    plain_ms = cuda_time_ms(lambda: plain(x))
    # the multiply-adds these weights need: the nonzero bands of both passes
    flops = 2.0 * 3 * b * preprocess_weights(cfg, h, w, "cpu").taps
    nbytes = b * 3 * h * w + b * c * c * 3 * 4
    bms, by = bound_ms(flops, nbytes, "f32_flops")
    case = {"case": name, "shape": [b, 3, h, w], "bit_equal": bit_equal,
            "max_abs_err": max(per_ch), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by, "gbps": None if dev_ms is None else nbytes / (dev_ms * 1e6)}
    print(f"[preprocess] {json.dumps(case)}")
    return case


def _maxsim_case(name, *, nq, tq, nd, td, dim, dtype, masked, rng, check_queries=None):
    import torch

    from multimodal_embedding_tpu_torch.ops import maxsim_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")

    # a large case makes its inputs on the card, from a seed drawn from rng
    gen = None if check_queries is None else torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))

    def unit(shape):  # unit-norm token embeddings, as ColPali's head gives
        if gen is None:
            x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q, d = unit((nq, tq, dim)), unit((nd, td, dim))
    qm = dm = None
    nq_valid, nd_valid = nq * tq, nd * td
    if masked:
        qm_np = (rng.random((nq, tq)) > 0.25).astype(np.float32)
        dm_np = rng.random((nd, td)) > 0.25
        dm_np[:, 0] = True  # every doc keeps a valid token
        qm, dm = torch.from_numpy(qm_np).to(dev), torch.from_numpy(dm_np).to(dev)
        nq_valid, nd_valid = int((qm_np != 0).sum()), int(dm_np.sum())
    out = maxsim_cuda.maxsim_cuda(q, d, qm, dm)
    torch.cuda.synchronize()
    # the plain version on the first check_queries queries (all by default)
    nc = nq if check_queries is None else check_queries
    plain = maxsim_cuda.maxsim_scores_ref(q[:nc], d, None if qm is None else qm[:nc], dm)
    err = float((out[:nc] - plain).abs().max())
    rel = err / float(plain.abs().max())
    del plain
    bf16 = dtype == torch.bfloat16
    tol = MAXSIM_REL_TOL_BF16 if bf16 else MAXSIM_REL_TOL_F32
    require(math.isfinite(rel) and rel <= tol, f"maxsim {name}: max|d|/max|plain| {rel} > {tol}")
    require(bool(out.isfinite().all()), f"maxsim {name}: non-finite scores")
    ms = cuda_time_ms(lambda: maxsim_cuda.maxsim_cuda(q, d, qm, dm))
    dev_ms = device_ms(lambda: maxsim_cuda.maxsim_cuda(q, d, qm, dm))
    plain_ms = None
    if check_queries is None:
        plain_ms = cuda_time_ms(lambda: maxsim_cuda.maxsim_scores_ref(q, d, qm, dm))
    # the dot products these masks need: weighted query tokens x valid doc tokens
    flops = 2.0 * dim * nq_valid * nd_valid
    nbytes = q.element_size() * dim * (nq * tq + nd * td) + 4 * nq * nd
    if masked:
        nbytes += 4 * nq * tq + nd * td
    bms, by = bound_ms(flops, nbytes, "bf16_flops" if bf16 else "f32_flops")
    case = {"case": name, "shape": [nq, tq, nd, td, dim], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_rel_err": rel, "checked_queries": nc, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms, "bound_by": by,
            "tflops": None if dev_ms is None else flops / (dev_ms * 1e9)}
    if not bf16:
        case["bound_3xtf32_ms"] = bound_ms(flops, nbytes, "tf32x3_flops")[0]
    print(f"[maxsim] {json.dumps(case)}")
    return case


def _rel_errs(got, plain) -> tuple[float, float, float]:
    """(max|d|, max|d|/max|plain|, mean|d|/mean|plain|) in f32."""
    diff = (got.float() - plain).abs()
    err = float(diff.max())
    return err, err / float(plain.abs().max()), float(diff.mean()) / float(plain.abs().mean())


def _prologue_case(name, *, m, d, n, dtype, has_delta, act, norm="ln", eps=1e-5, rng):
    import torch

    from multimodal_embedding_tpu_torch.ops import fused_ln_matmul_cuda as fl
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")

    def rand(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev, dtype)

    x = rand((m, d))
    delta = rand((m, d), 0.5) if has_delta else None
    gamma = 1.0 + rand((d,), 0.1) if norm == "ln" else rand((d,), 0.1)
    beta, b = (rand((d,), 0.1), rand((n,), 0.1)) if norm == "ln" else (None, None)
    w = rand((d, n), d ** -0.5)
    args = (x, delta, gamma, beta, w, b)
    kw = dict(norm=norm, eps=eps, act=act)
    x_new, y = fl.fused_res_norm_matmul(*args, **kw)
    torch.cuda.synchronize()
    want_x, _ = fl.reference(*args, **kw)
    require(torch.equal(x_new, want_x), f"prologue {name}: x_new is not bit-equal to the plain version")
    f32 = [None if t is None else t.float() for t in args]
    _, plain_y = fl.reference(*f32, **kw)
    err, max_rel, mean_rel = _rel_errs(y, plain_y)
    del plain_y
    tol = PROLOGUE_REL_TOL_BF16 if dtype == torch.bfloat16 else PROLOGUE_REL_TOL_F32
    require(math.isfinite(err) and max_rel <= tol and mean_rel <= tol,
            f"prologue {name}: relative err max {max_rel}, mean {mean_rel} > {tol}")
    # the row pass alone (an archive of an older port has no such entry: then None)
    rows = getattr(fl, "fused_res_norm_rows", None)
    rows_kw = dict(norm=norm, eps=eps)
    row_extra = {}
    if rows is not None:
        rx, rh = rows(*args[:4], **rows_kw)
        torch.cuda.synchronize()
        require(torch.equal(rx, want_x), f"prologue {name}: the row pass's x_new is not bit-equal")
        _, h_err, h_mean = _rel_errs(rh, fl.reference_rows(*f32[:4], **rows_kw)[1])
        require(h_err <= tol and h_mean <= tol, f"prologue {name}: the row pass's h relative err {h_err} > {tol}")
        row_extra = {"h_max_rel_err": h_err, "row_device_ms": device_ms(lambda: rows(*args[:4], **rows_kw))}
        del rx, rh
    ms = cuda_time_ms(lambda: fl.fused_res_norm_matmul(*args, **kw))
    dev_ms = device_ms(lambda: fl.fused_res_norm_matmul(*args, **kw))
    plain_ms = cuda_time_ms(lambda: fl.reference(*args, **kw))
    h = torch.empty(m, d, dtype=dtype, device=dev)  # for orientation: the bare product with its bias

    def addmm():
        return torch.addmm(b, h, w) if b is not None else torch.mm(h, w)

    addmm_ms, addmm_dev_ms = cuda_time_ms(addmm), device_ms(addmm)
    del h
    es = x.element_size()
    flops = 2.0 * m * d * n
    nbytes = es * (m * d * (2 + has_delta) + d * n + m * n + 2 * d + n)
    bms, by = bound_ms(flops, nbytes, "bf16_flops" if dtype == torch.bfloat16 else "f32_flops")
    if row_extra and dev_ms is not None and row_extra["row_device_ms"] is not None:
        prod_ms = dev_ms - row_extra["row_device_ms"]
        row_extra.update(product_device_ms=prod_ms, product_tflops=flops / (prod_ms * 1e9))
    case = {"case": name, "shape": [m, d, n], "dtype": str(dtype).replace("torch.", ""), "delta": has_delta,
            "act": act, "norm": norm, "eps": eps, "x_new_bit_equal": True, "max_abs_err": err,
            "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "device_ms": dev_ms,
            "tflops": None if dev_ms is None else flops / (dev_ms * 1e9), **row_extra, "plain_ms": plain_ms, "library_ms": None,
            # no one PyTorch call computes the prologue: addmm alone, for orientation
            "addmm_ms": addmm_ms, "library_device_ms": addmm_dev_ms, "bound_ms": bms, "bound_by": by}
    print(f"[prologue] {json.dumps(case)}")
    return case


def _attention_qkv_case(name, *, b, h, t, dh, dtype, causal, masked, full_mask_rows, rng):
    import torch
    import torch.nn.functional as F

    from multimodal_embedding_tpu_torch.ops import attention_cuda as ac
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * dh), dtype=np.float32)).to(dev, dtype)
    km = None
    if masked:
        lengths = rng.integers(3, t + 1, size=b)
        km_np = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
        if full_mask_rows:
            km_np[-1] = 0  # every query row of the last sequence is fully masked
        km = torch.from_numpy(km_np).to(dev)
    kw = dict(causal=causal, num_heads=h)
    out = ac.fused_attention_qkv(qkv, km, **kw)
    q, k, v = ac._split_qkv(qkv, h, h)
    same = ac.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), km, layout="packed", **kw)
    torch.cuda.synchronize()
    require(torch.equal(out, same), f"attention_qkv {name}: not bit-equal to fused_attention on copies")
    scale = 1.0 / math.sqrt(dh)
    plain = ac._plain_qkv(qkv.float(), km, causal, scale, h, h)
    err, max_rel, mean_rel = _rel_errs(out, plain)
    bf16 = dtype == torch.bfloat16
    tol, rel_tol = (ATTN_TOL_BF16, ATTN_REL_TOL_BF16) if bf16 else (ATTN_TOL_F32, ATTN_REL_TOL_F32)
    require(math.isfinite(err) and err <= tol, f"attention_qkv {name}: max abs err {err} > {tol}")
    require(max_rel <= rel_tol and mean_rel <= rel_tol,
            f"attention_qkv {name}: relative err max {max_rel}, mean {mean_rel} > {rel_tol}")
    if full_mask_rows:
        require(bool((out[-1] == 0).all()), f"attention_qkv {name}: fully masked sequence not exact zeros")
    ms = cuda_time_ms(lambda: ac.fused_attention_qkv(qkv, km, **kw))
    dev_ms = device_ms(lambda: ac.fused_attention_qkv(qkv, km, **kw))
    plain_ms = cuda_time_ms(lambda: ac._plain_qkv(qkv, km, causal, scale, h, h))
    q4, k4, v4 = (x.reshape(b, t, h, dh).transpose(1, 2) for x in (q, k, v))  # views, no copy
    valid = torch.ones(b, 1, t, t, dtype=torch.bool, device=dev)
    if km is not None:
        valid = valid & km.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    attn_mask = valid if (masked or causal) else None

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)

    library_ms = cuda_time_ms(sdpa)
    pairs = float(valid.sum()) * h
    flops = 4.0 * pairs * dh
    nbytes = qkv.element_size() * dh * 4 * b * t * h + (b * t if km is not None else 0)
    bms, by = bound_ms(flops, nbytes, "bf16_flops" if bf16 else "f32_flops")
    case = {"case": name, "shape": [b, t, 3 * h * dh], "heads": h, "dtype": str(dtype).replace("torch.", ""),
            "bit_equal_to_fused_attention": True, "max_abs_err": err, "max_rel_err": max_rel,
            "mean_rel_err": mean_rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by, "tflops": flops / (ms * 1e9), "device_ms": dev_ms}
    if not bf16:
        case.update(_f32_extras(flops, nbytes, dev_ms, sdpa))
    print(f"[attention_qkv] {json.dumps(case)}")
    return case


def _layer_norm_case(name, *, m, d, dtype, eps, rng):
    import torch
    import torch.nn.functional as F

    from multimodal_embedding_tpu_torch.ops import layernorm_cuda as lnc
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((m, d), dtype=np.float32) * 2 + 0.5).to(dev, dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(dev, dtype)
    bias = torch.from_numpy(0.1 * rng.standard_normal(d, dtype=np.float32)).to(dev, dtype)
    out = lnc.fused_layer_norm(x, scale, bias, eps=eps)
    torch.cuda.synchronize()
    plain = lnc.reference(x.float(), scale.float(), bias.float(), eps=eps)
    err, max_rel, mean_rel = _rel_errs(out, plain)
    del plain
    tol = LN_REL_TOL_BF16 if dtype == torch.bfloat16 else LN_REL_TOL_F32
    require(math.isfinite(err) and max_rel <= tol and mean_rel <= tol,
            f"layernorm {name}: relative err max {max_rel}, mean {mean_rel} > {tol}")
    ms = cuda_time_ms(lambda: lnc.fused_layer_norm(x, scale, bias, eps=eps))
    dev_ms = device_ms(lambda: lnc.fused_layer_norm(x, scale, bias, eps=eps))
    plain_ms = cuda_time_ms(lambda: lnc.reference(x, scale, bias, eps=eps))
    library_ms = cuda_time_ms(lambda: F.layer_norm(x, (d,), scale, bias, eps))
    library_dev_ms = device_ms(lambda: F.layer_norm(x, (d,), scale, bias, eps))
    nbytes = x.element_size() * (2 * m * d + 2 * d)
    bms, by = bound_ms(8.0 * m * d, nbytes, "f32_flops")
    case = {"case": name, "shape": [m, d], "dtype": str(dtype).replace("torch.", ""), "eps": eps,
            "max_abs_err": err, "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_device_ms": library_dev_ms, "bound_ms": bms,
            "bound_by": by}
    print(f"[layernorm] {json.dumps(case)}")
    return case


def _ulps(got, want):
    """Units in the last place between two tensors of one float dtype,
    element by element (+0 and -0 the same point)."""
    import torch

    bits, mag = (torch.int16, 0x7FFF) if got.element_size() == 2 else (torch.int32, 0x7FFFFFFF)

    def ordered(t):
        b = t.view(bits).to(torch.int64)
        return torch.where(b < 0, -(b & mag), b & mag)

    return (ordered(got) - ordered(want)).abs()


def _activation_case(name, *, m, n, act, dtype, rng):
    """The MLP activation kernel on normals x 3 at a tower's fc1 output
    [tokens, mlp_dim]: at most one ulp (two in f32) from the plain version in
    the same dtype and bit-equal on at least 99.9% of the elements; its
    device time against the bytes bound (one read, one write), the plain
    composition's (``plain_device_ms``: five launches for quick_gelu, three
    for the GELUs in bf16) and, for the GELUs, ``F.gelu`` on the same dtype
    (one ATen launch that computes the same function; the port does not call
    it)."""
    import torch
    import torch.nn.functional as F

    from multimodal_embedding_tpu_torch.ops import activation_cuda as ac
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    h = (torch.randn((m, n), generator=gen, device=dev) * 3).to(dtype)
    y = ac.mlp_activation(h, act)
    torch.cuda.synchronize()
    want = ac.reference(h, act)
    d = _ulps(y, want)
    max_ulps, bit_equal = int(d.max()), float((d == 0).double().mean())
    err = float((y.float() - want.float()).abs().max())
    del want, d
    ulps_limit = 2 if dtype == torch.float32 else 1
    require(max_ulps <= ulps_limit and bit_equal >= ACT_MIN_BIT_EQUAL,
            f"activation {name}: {max_ulps} ulps at most, {bit_equal} bit-equal")
    ms = cuda_time_ms(lambda: ac.mlp_activation(h, act))
    dev_ms = device_ms(lambda: ac.mlp_activation(h, act))
    plain_ms = cuda_time_ms(lambda: ac.reference(h, act))
    plain_dev_ms = device_ms(lambda: ac.reference(h, act))
    library_ms = library_dev_ms = None
    if act != "quick_gelu":
        approximate = "tanh" if act == "gelu_pytorch_tanh" else "none"
        library_ms = cuda_time_ms(lambda: F.gelu(h, approximate=approximate))
        library_dev_ms = device_ms(lambda: F.gelu(h, approximate=approximate))
    nbytes = 2.0 * h.numel() * h.element_size()
    bms, by = bound_ms(0.0, nbytes, "f32_flops")
    case = {"case": name, "shape": [m, n], "act": act, "dtype": str(dtype).replace("torch.", ""),
            "max_ulps": max_ulps, "bit_equal": bit_equal, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "bound_ms": bms, "bound_by": by,
            "bound_pct": None if dev_ms is None else 100.0 * bms / dev_ms,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms, "library_ms": library_ms,
            "library_device_ms": library_dev_ms}
    print(f"[activation] {json.dumps(case)}")
    return case


def _moe_swiglu_case(name, *, m, width, rng):
    """The MoE SwiGLU kernel on normals x 3 at [rows, 2I]: bit-equal to its
    plain composition; its device time against the bytes bound (one read of
    h, one write of [rows, I]) and the plain composition's (the f32 cast,
    SiLU, the product, the cast back: the ATen chain it replaces)."""
    import torch

    from multimodal_embedding_tpu_torch.ops import moe as tmoe
    from multimodal_embedding_tpu_torch.ops import moe_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    h = (torch.randn((m, width), generator=gen, device=dev) * 3).to(torch.bfloat16)
    y = moe_cuda.swiglu(h)
    want = tmoe.swiglu_plain(h)
    differ = int((y.view(torch.int16) != want.view(torch.int16)).sum())
    bit_equal = 1.0 - differ / y.numel()
    del y, want
    require(differ == 0, f"moe swiglu {name}: {differ} elements differ from the plain version")
    nbytes = (m * width + m * width // 2) * h.element_size()
    bms, by = bound_ms(0.0, nbytes, "f32_flops")
    dev_ms = device_ms(lambda: moe_cuda.swiglu(h))
    case = {"case": name, "op": "swiglu", "shape": [m, width], "dtype": "bfloat16", "bit_equal": bit_equal,
            "max_abs_err": 0.0, "ms": cuda_time_ms(lambda: moe_cuda.swiglu(h)), "device_ms": dev_ms,
            "bound_ms": bms, "bound_by": by, "bound_pct": None if dev_ms is None else 100.0 * bms / dev_ms,
            "plain_ms": cuda_time_ms(lambda: tmoe.swiglu_plain(h)),
            "plain_device_ms": device_ms(lambda: tmoe.swiglu_plain(h)), "library_ms": None}
    print(f"[moe_glue] {json.dumps(case)}")
    return case


def _bf16_step(x):
    """The spacing of bf16 values at |x| (0 at 0)."""
    import torch

    a = x.float().abs()
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8), torch.zeros_like(a))


def _moe_combine_case(name, *, n, k, d, rng, router="deepseek"):
    """The MoE combine kernel with the shared experts' addend at n tokens, k
    choices, width d, routed by a Kimi-VL-A3B router (``router`` "deepseek":
    64 experts, weights drawn as the arch model draws them) or a
    Granite-4.0-H one ("granite": 72 experts, the softmax of the top k
    logits; k above 8 takes the kernel's 16-choice build): bit-equal to the choice-order f32
    composition; without the addend, apart from the plain ``combine`` (ATen's
    order of the sum) by at most one bf16 step of the result plus the two f32
    orders' bound, 2 (k - 1) 2^-24 sum_j |w_j y_j| (more than a bf16 step of a
    result where the terms cancel), with the largest gap in bf16 steps and
    the share of bit-equal elements; its device time against the bytes bound (the k sorted rows,
    the addend, the row indices and weights read once, the output written
    once) and the parent's ATen chain's (the permutation back by
    ``index_put``, the cast, the weighted product, the sum over the choices,
    the cast back, the add); ``index_put`` alone and the gather ``x[r.token]``
    that feeds the first grouped product alone (the two share ATen's
    ``index_elementwise_kernel``)."""
    import torch

    from multimodal_embedding_tpu_torch.ops import moe as tmoe
    from multimodal_embedding_tpu_torch.ops import moe_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    x = torch.randn((n, d), generator=gen, device=dev).to(bf16)
    if router == "granite":
        r = tmoe.route_softmax(x, torch.randn((72, d), generator=gen, device=dev) * 0.02, top_k=k)
    else:
        w_router = torch.randn((64, d), generator=gen, device=dev) * 0.02
        bias = torch.randn((64,), generator=gen, device=dev) * 0.02
        r = tmoe.route(x, w_router, bias, top_k=k, scale=2.446, normalize=True)
    y = (torch.randn((n * k, d), generator=gen, device=dev) * 0.05).to(bf16)
    shared = (torch.randn((n, d), generator=gen, device=dev) * 0.05).to(bf16)
    # each sorted row's place among the unsorted (token * k + choice): rows inverted
    order = torch.empty_like(r.token).scatter_(0, r.rows.view(-1), torch.arange(n * k, device=dev))

    def kernel():
        return moe_cuda.combine(y, r.rows, r.weights, shared)

    def choice_order():
        prod = y[r.rows].float() * r.weights[..., None]
        acc = prod[:, 0]
        for j in range(1, k):
            acc = acc + prod[:, j]
        return (acc.to(bf16).float() + shared.float()).to(bf16)

    def parent_chain():
        unsorted = torch.empty_like(y)
        unsorted[order] = y
        return (unsorted.view(n, k, -1).float() * r.weights[..., None]).sum(dim=1).to(bf16) + shared

    def index_put():
        unsorted = torch.empty_like(y)
        unsorted[order] = y
        return unsorted

    got = kernel()
    differ = int((got.view(torch.int16) != choice_order().view(torch.int16)).sum())
    err = float((got.float() - parent_chain().float()).abs().max())
    routed, plain = moe_cuda.combine(y, r.rows, r.weights), tmoe.combine_plain(y, r)
    gap = (routed.float() - plain.float()).abs()
    terms = (y[r.rows].float() * r.weights[..., None]).abs().sum(dim=1)
    slack = float((gap - _bf16_step(torch.maximum(routed.float().abs(), plain.float().abs()))
                   - 2 * (k - 1) * 2.0**-24 * terms).max())
    ri, pi = routed.view(torch.int16).to(torch.int32), plain.view(torch.int16).to(torch.int32)
    ulps = int((torch.where(ri < 0, -(ri & 0x7FFF), ri) - torch.where(pi < 0, -(pi & 0x7FFF), pi)).abs().max())
    plain_equal = float(int((ri == pi).sum()) / ri.numel())
    del got, routed, plain, gap, terms, ri, pi
    require(differ == 0 and slack <= 0,
            f"moe combine {name}: {differ} elements differ from the choice-order sum; "
            f"{slack} past the bound on the gap to the plain one")
    bit_equal = 1.0
    nbytes = (n * k * d + 2 * n * d) * y.element_size() + n * k * (8 + 4)
    bms, by = bound_ms(0.0, nbytes, "f32_flops")
    dev_ms = device_ms(kernel)
    case = {"case": name, "op": "combine", "router": router, "n": n, "k": k, "d": d, "dtype": "bfloat16",
            "bit_equal": bit_equal,
            "routed_max_steps_vs_plain": ulps, "routed_bit_equal_to_plain": plain_equal, "max_abs_err": err,
            "ms": cuda_time_ms(kernel), "device_ms": dev_ms,
            "bound_ms": bms, "bound_by": by, "bound_pct": None if dev_ms is None else 100.0 * bms / dev_ms,
            "plain_ms": cuda_time_ms(parent_chain), "plain_device_ms": device_ms(parent_chain),
            "index_put_device_ms": device_ms(index_put), "gather_device_ms": device_ms(lambda: x[r.token]),
            "library_ms": None}
    print(f"[moe_glue] {json.dumps(case)}")
    return case


def _moe_graph_case(name, *, rng, decoder="deepseek", tag="moe_glue"):
    """A caption batch of a MoE ColPali decoder at full width and depth
    (arch-random weights on the card) through ``text_fwd``: its CUDA graph
    captured, then replayed, each call bit-equal to the eager forward and
    adding the eager forward's launch counts, each call's counts set to 0
    just before it and read just after. ``decoder`` "deepseek"
    (``ColPali-KimiVL-A3B``): 53 ``moe_swiglu`` and 26 ``moe_combine`` a
    forward; "granite" (``ColPali-Granite-4.0-H-Small``): 80 ``moe_swiglu``,
    40 ``moe_combine`` and 36 ``ssm_scan``, each on the scan's chunked body
    (36 ``ssm_scan_chunked``); "kimi_linear" (``ColPali-Kimi-Linear-48B-A3B``,
    the benchmark's 16 layers): 31 ``moe_swiglu``, 15 ``moe_combine`` and 12
    ``kda_scan``.
    The two hybrids also run a page batch (8 pages of 1030 tokens) through
    ``image_fwd`` with the same counts. The launches of the Kimi main path
    are phase 3's."""
    import torch

    from multimodal_embedding_tpu_torch.models.arch import (full_colpali_deepseek_config, full_colpali_granite_config,
                                                            full_colpali_kimi_linear_config)
    from multimodal_embedding_tpu_torch.models.colpali import ColPali
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    t0 = time.perf_counter()
    cfg = {"granite": full_colpali_granite_config, "kimi_linear": full_colpali_kimi_linear_config}.get(
        decoder, full_colpali_deepseek_config)()
    model = ColPali(cfg, COLPALI_SUFFIX_IDS.tolist(), seed=0, device=dev, dtype=torch.bfloat16)
    lm = model.gemma.cfg
    if decoder == "granite":
        want = {"moe_swiglu": 2 * lm.layers, "moe_combine": lm.layers, "grouped_mm": 2 * lm.layers,
                "ssm_scan": lm.mamba_layers, "ssm_scan_chunked": lm.mamba_layers}
        require(want == {"moe_swiglu": 80, "moe_combine": 40, "grouped_mm": 80, "ssm_scan": 36,
                         "ssm_scan_chunked": 36}, f"moe graph {name}: Granite-4.0-H-Small's layers give {want}")
    elif decoder == "kimi_linear":
        want = {"moe_swiglu": 2 * lm.moe_layers + lm.first_dense, "moe_combine": lm.moe_layers,
                "grouped_mm": 2 * lm.moe_layers, "kda_scan": len(lm.kda_layers)}
        require(want == {"moe_swiglu": 31, "moe_combine": 15, "grouped_mm": 30, "kda_scan": 12},
                f"moe graph {name}: Kimi-Linear's 16 layers give {want}")
    else:
        want = {"moe_swiglu": 2 * lm.moe_layers + lm.first_dense, "moe_combine": lm.moe_layers,
                "grouped_mm": 2 * lm.moe_layers, "ssm_scan": 0, "ssm_scan_chunked": 0, "kda_scan": 0}

    def counted(fn, *args):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        counts = launch_counts()
        return out, {key: counts[key] for key in want}

    ids = torch.randint(1, lm.vocab_size, (32, 24), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[16:, 19:] = 0
    ids = ids * mask
    page = None
    with torch.inference_mode():
        if decoder in ("granite", "kimi_linear"):
            pixels = torch.rand(8, cfg.vision.image_size, cfg.vision.image_size, 3, generator=gen, device=dev)
            out, page = counted(model.image_fwd, pixels)
            require(page == want and bool(torch.isfinite(out).all()),
                    f"moe graph {name}: a page batch's counts {page}, want {want}; finite: {bool(torch.isfinite(out).all())}")
            del out, pixels
        eager_out, eager = counted(model._text, ids, mask)
        graphed = [counted(model.text_fwd, ids, mask) for _ in range(3)]  # capture, then replays
    replay_equal = all(torch.equal(out, eager_out) for out, _ in graphed)
    calls = {"eager": eager, "graph_calls": [c for _, c in graphed]}
    require(eager == want and all(c == want for _, c in graphed) and replay_equal,
            f"moe graph {name}: counts {calls}, want {want} a forward; replays bit-equal: {replay_equal}")
    del model, eager_out, graphed
    torch.cuda.empty_cache()
    case = {"case": name, "op": "graph", "decoder": decoder, "want_a_forward": want, "caption": calls,
            "page_batch": page, "caption_replay_bit_equal": replay_equal, "seconds": time.perf_counter() - t0}
    print(f"[{tag}] {json.dumps(case)}")
    return case


def _ssm_inputs(b, t, gen, dtype, near_one=False):
    """A Mamba-2 layer's scan inputs at Granite-4.0-H-Small's widths (128
    heads of 64, state 128), at the scale the cell's weights feed it: x, B
    and C SiLU outputs, views into one [b, t, 8192 + 256] tensor as the
    conv's output holds them; dt the softplus of the initialiser's range; A
    in [-16, -1] (f32); D ones. ``near_one``: dt about 1e-3 and A about -1,
    decays of about 0.999 that carry the state over a page."""
    import torch

    h, p, n = 128, 64, 128
    dev = gen.device
    xbc = torch.nn.functional.silu(torch.randn(b, t, h * p + 2 * n, generator=gen, device=dev)).to(dtype)
    x, bm, cm = xbc.split([h * p, n, n], dim=-1)
    if near_one:
        dt = (1e-3 * (1 + 0.2 * torch.rand(b, t, h, generator=gen, device=dev))).to(dtype)
        a = -(0.8 + 0.4 * torch.rand(h, generator=gen, device=dev))
    else:
        raw = torch.randn(b, t, h, generator=gen, device=dev) * 1.28 + torch.rand(h, generator=gen, device=dev) * 4.6 \
            - 6.9
        dt = torch.nn.functional.softplus(raw).to(dtype)
        a = -(1 + 15 * torch.rand(h, generator=gen, device=dev))
    return x.unflatten(-1, (h, p)), dt, a, bm, cm, torch.ones(h, device=dev, dtype=dtype)


def _ssm_scan_case(name, *, b, t, rng, dtype="bfloat16", near_one=False):
    """The scan kernel over b sequences of t tokens (``_ssm_inputs``) against
    its plain version on the same inputs (``ops/ssm.py:scan_plain``, chunk
    256, run here as the reference only): in bf16 within one bf16 step of
    the plain output plus 1e-4 of its largest magnitude, and at most 1% of
    the bf16 outputs differing from the plain's, in f32 within 1e-4 of it
    (the card tests' limits: both round an f32 result once and sum the state
    in other orders); one ``ssm_scan`` launch a call, and one
    ``ssm_scan_chunked`` in bf16 (its body, ``ssm_cuda.uses_chunked``); its
    device time against the bound of the recurrence's work at the cell's
    precision (``perfbench/yardstick_hybrid.py:ssm_work``: x, dt, B and C
    read once and y written once, the operations at the bf16 peak), and the
    plain scan's."""
    import torch

    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts, ssm, ssm_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms
    from perfbench import yardstick_hybrid

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    dt_ = getattr(torch, dtype)
    args = _ssm_inputs(b, t, gen, dt_, near_one)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        got = ssm.scan(*args, chunk=256)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches, chunked = counts["ssm_scan"], counts["ssm_scan_chunked"]
        want = ssm.scan_plain(*args, chunk=256)
    bf16 = dt_ == torch.bfloat16
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    step = torch.finfo(torch.bfloat16).eps * w.abs() if bf16 else torch.zeros_like(w)
    excess = float(((g - w).abs() - step - 1e-4 * top).max())
    err = float((g - w).abs().max())
    differing = float((got != want).float().mean()) if bf16 else None
    del got, want, g, w, step
    require(launches == 1 and chunked == int(ssm_cuda.uses_chunked(dt_)) and excess <= 0
            and (differing is None or differing <= 0.01),
            f"ssm scan {name}: {launches} launches ({chunked} chunked), {excess} past one bf16 step plus 1e-4 of "
            f"{top}, {differing} of the outputs differing")
    cfg = json.loads((ROOT / "perfbench/configs/colpali-granite-4.0-h-small.json").read_text())
    flops, nbytes = yardstick_hybrid.ssm_work(cfg, b * t)
    nbytes *= args[0].element_size() / 2  # counted in bf16
    bms, by = bound_ms(flops, nbytes, "bf16_flops")
    with torch.inference_mode():
        dev_ms = device_ms(lambda: ssm.scan(*args, chunk=256))
        ms = cuda_time_ms(lambda: ssm.scan(*args, chunk=256))
        plain_ms = cuda_time_ms(lambda: ssm.scan_plain(*args, chunk=256))
        plain_dev_ms = device_ms(lambda: ssm.scan_plain(*args, chunk=256))
    case = {"case": name, "op": "scan", "shape": [b, t, 128, 64], "state": 128, "dtype": dtype,
            "body": "chunked" if chunked else "recurrent", "near_one_decays": near_one,
            "launches_a_call": launches, "max_abs_err": err, "max_abs_out": top, "differing_share": differing,
            "ms": ms, "device_ms": dev_ms,
            "bound_ms": bms, "bound_by": by, "bound_pct": None if dev_ms is None else 100.0 * bms / dev_ms,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms, "library_ms": None}
    print(f"[ssm] {json.dumps(case)}")
    return case


def _ssm_case(name, *, op, rng, **kw):
    """One ``ssm`` case: ``op`` "scan" or "graph" (the Granite decoder's)."""
    if op == "graph":
        return _moe_graph_case(name, rng=rng, decoder="granite", tag="ssm")
    return _ssm_scan_case(name, **kw, rng=rng)


def _kda_scan_case(name, *, b, t, rng, dtype="bfloat16", check_rows=None):
    """The KDA kernel over b sequences of t tokens at Kimi-Linear's widths (32
    heads of 128; q, k and v SiLU outputs, views into one [b, t, 3 x 4096]
    tensor as the convs' output holds them; A in [1, 16] a head and dt
    log-uniform on [0.001, 0.1] a channel; beta a sigmoid) against its plain
    version on CPU copies of the first ``check_rows`` sequences
    (``ops/kda.py:kda_plain``; the kernel runs each sequence on its own):
    within 1e-4 of its largest magnitude, in bf16 plus one bf16 step of the
    plain output (the card tests' limits); one ``kda_scan`` launch a call; its
    device time against the bound of the recurrence's work
    (``perfbench/yardstick_kda.py:kda_work``: q, k and v read and o written
    once in bf16, g and beta read once in f32, 7 K V operations a token and
    head at the bf16 peak)."""
    import math

    import torch

    from multimodal_embedding_tpu_torch.ops import kda, launch_counts, reset_launch_counts
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms
    from perfbench import yardstick_kda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    dt_ = getattr(torch, dtype)
    h, n = 32, 32 * 128
    qkv = torch.nn.functional.silu(torch.randn(b, t, 3 * n, generator=gen, device=dev)).to(dt_)
    q, k, v = (x.unflatten(-1, (h, 128)) for x in qkv.split(n, dim=-1))
    a = 1 + 15 * torch.rand(h, generator=gen, device=dev)
    u = torch.rand(b, t, h, 128, generator=gen, device=dev)
    g = -a[:, None] * torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    beta = torch.sigmoid(torch.randn(b, t, h, generator=gen, device=dev))
    args = (q, k, v, g, beta)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        got = kda.kda(*args)
        torch.cuda.synchronize()
        counts = launch_counts()
    rows = b if check_rows is None else check_rows
    want = kda.kda_plain(*(x[:rows].cpu() for x in args))
    gf, w = got[:rows].float().cpu(), want.float()
    top = float(w.abs().max())
    bf16 = dt_ == torch.bfloat16
    step = 2.0**-7 * w.abs() if bf16 else torch.zeros_like(w)
    excess = float(((gf - w).abs() - step - 1e-4 * top).max())
    err = float((gf - w).abs().max())
    del got, want, gf, w, step
    require(counts["kda_scan"] == 1 and excess <= 0,
            f"kda {name}: {counts['kda_scan']} launches, {excess} past its limit (max {top})")
    cfg = json.loads((ROOT / "perfbench/configs/colpali-kimi-linear-48b-a3b.json").read_text())
    flops, nbytes = yardstick_kda.kda_work(cfg, b * t)
    bms, by = bound_ms(flops, nbytes, "bf16_flops")
    with torch.inference_mode():
        dev_ms = device_ms(lambda: kda.kda(*args))
        ms = cuda_time_ms(lambda: kda.kda(*args))
    case = {"case": name, "op": "kda", "shape": [b, t, h, 128], "dtype": dtype, "checked_rows": rows,
            "launches_a_call": counts["kda_scan"], "max_abs_err": err, "excess": excess, "max_abs_out": top,
            "ms": ms, "device_ms": dev_ms, "bound_ms": bms, "bound_by": by,
            "bound_pct": None if dev_ms is None else 100.0 * bms / dev_ms, "plain_ms": None, "library_ms": None}
    print(f"[kda] {json.dumps(case)}")
    return case


def _kda_case(name, *, op="scan", rng, **kw):
    """One ``kda`` case: ``op`` "scan" or "graph" (the Kimi-Linear decoder's)."""
    if op == "graph":
        return _moe_graph_case(name, rng=rng, decoder="kimi_linear", tag="kda")
    return _kda_scan_case(name, **kw, rng=rng)


def _moe_glue_case(name, *, op, rng, **kw):
    """One ``moe_glue`` case: ``op`` "swiglu", "combine" or "graph"."""
    return {"swiglu": _moe_swiglu_case, "combine": _moe_combine_case, "graph": _moe_graph_case}[op](name, **kw, rng=rng)


def attention_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    return [
        ("vit-l packed", dict(b=64, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                              layout="packed", full_mask_rows=False)),
        # the benchmark cells' CLIP-L vision batch of 32 (their caption batch,
        # SigLIP-400M's vision, MAP head and caption batches follow below)
        ("vit-l b32 packed", dict(b=32, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                                  layout="packed", full_mask_rows=False)),
        ("clip-l text packed causal+mask", dict(b=128, h=12, kvh=12, t=77, dh=64, dtype=bf16, causal=True,
                                                masked=True, layout="packed", full_mask_rows=False)),
        ("gqa bhtd causal+mask, fully masked rows", dict(b=4, h=8, kvh=2, t=100, dh=64, dtype=bf16, causal=True,
                                                         masked=True, layout="bhtd", full_mask_rows=True)),
        ("f32 packed causal+mask", dict(b=4, h=4, kvh=4, t=77, dh=64, dtype=torch.float32, causal=True,
                                        masked=True, layout="packed", full_mask_rows=True)),
        # ColPali-v1.3: SigLIP-448 (Dh 72), Gemma MQA (Dh 256) over 1024 image
        # + 6 suffix tokens, and the Gemma text sweep (key mask, not causal)
        ("colpali siglip-448 packed", dict(b=8, h=16, kvh=16, t=1024, dh=72, dtype=bf16, causal=False,
                                           masked=False, layout="packed", full_mask_rows=False)),
        ("colpali gemma image packed mqa", dict(b=8, h=8, kvh=1, t=1030, dh=256, dtype=bf16, causal=False,
                                                masked=False, layout="packed", full_mask_rows=False)),
        ("colpali gemma text packed mqa+mask", dict(b=128, h=8, kvh=1, t=32, dh=256, dtype=bf16, causal=False,
                                                    masked=True, layout="packed", full_mask_rows=False)),
        # ViT-H/14 at 224 (Dh 80, 257 tokens): the head-dim bucket between
        # CLIP's 64 and Gemma's 256; a key row of 4096, past the f32 kernel's
        # shared-memory limit
        ("vit-h packed", dict(b=64, h=16, kvh=16, t=257, dh=80, dtype=bf16, causal=False, masked=False,
                              layout="packed", full_mask_rows=False)),
        ("long key row bhtd", dict(b=1, h=2, kvh=2, t=4096, dh=64, dtype=bf16, causal=False, masked=False,
                                   layout="bhtd", full_mask_rows=False)),
        # the other five models' paths (32 images, 128 captions a batch):
        # SigLIP-So400m's vision tower (729 tokens, Dh 72), its MAP head (one
        # probe row over those 729 keys) and its text tower (64 tokens, key
        # mask, not causal); DFN5B at 378 px (730 tokens, Dh 80); the ViT-H
        # text tower (77 tokens, Dh 64, causal with a key mask)
        ("siglip-400m vision packed", dict(b=32, h=16, kvh=16, t=729, dh=72, dtype=bf16, causal=False,
                                           masked=False, layout="packed", full_mask_rows=False)),
        ("siglip-400m map head packed 1x729", dict(b=32, h=16, kvh=16, t=729, tq=1, dh=72, dtype=bf16,
                                                   causal=False, masked=False, layout="packed",
                                                   full_mask_rows=False)),
        ("siglip-400m text packed mask", dict(b=128, h=16, kvh=16, t=64, dh=72, dtype=bf16, causal=False,
                                              masked=True, layout="packed", full_mask_rows=False)),
        ("dfn5b vision packed", dict(b=32, h=16, kvh=16, t=730, dh=80, dtype=bf16, causal=False, masked=False,
                                     layout="packed", full_mask_rows=False)),
        ("vit-h text packed causal+mask", dict(b=128, h=16, kvh=16, t=77, dh=64, dtype=bf16, causal=True,
                                               masked=True, layout="packed", full_mask_rows=False)),
        # one rank's heads of ViT-L under --tensor-parallel 2 (phase 10)
        ("vit-l tp2 shard packed", dict(b=64, h=8, kvh=8, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                                        layout="packed", full_mask_rows=False)),
        # the shapes phase 10's CLI paths launch, a rank: --tensor-parallel 2
        # (half the heads, the text shard's packed row 384 wide) and plain
        # data parallelism (half the rows) over batches of 32 images and 128
        # captions
        ("vit-l tp2 shard b32 packed", dict(b=32, h=8, kvh=8, t=577, dh=64, dtype=bf16, causal=False,
                                            masked=False, layout="packed", full_mask_rows=False)),
        ("clip-l text tp2 shard packed causal+mask", dict(b=128, h=6, kvh=6, t=77, dh=64, dtype=bf16, causal=True,
                                                          masked=True, layout="packed", full_mask_rows=False)),
        ("vit-l dp2 rows packed", dict(b=16, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                                       layout="packed", full_mask_rows=False)),
        ("clip-l text dp2 rows packed causal+mask", dict(b=64, h=12, kvh=12, t=77, dh=64, dtype=bf16, causal=True,
                                                         masked=True, layout="packed", full_mask_rows=False)),
        # Workload B's prefill (phase 8), prompts left-padded to 256: Qwen3-14B
        # (40 query heads over 8 KV heads, Dh 128) in bf16, and the CLI's small
        # Qwen3 (8 over 4, Dh 64) in f32, its random init's dtype
        ("qwen3-14b prefill packed gqa causal+mask, left-padded", dict(
            b=64, h=40, kvh=8, t=256, dh=128, dtype=bf16, causal=True, masked=True, layout="packed",
            full_mask_rows=True, left_padded=True)),
        ("qwen3-small prefill", dict(b=8, h=8, kvh=4, t=256, dh=64, dtype=torch.float32, causal=True, masked=True,
                                     layout="packed", full_mask_rows=True, left_padded=True)),
        # Qwen3-14B's heads in f32: cli/verify_rl.py on an f32 --save-base
        # base (batch 64, prompts left-padded to 256); and an f32 key row of
        # 4096, which the f32 kernel takes as the bf16 one does
        ("qwen3-14b f32 prefill packed gqa causal+mask, left-padded", dict(
            b=64, h=40, kvh=8, t=256, dh=128, dtype=torch.float32, causal=True, masked=True, layout="packed",
            full_mask_rows=True, left_padded=True)),
        ("f32 long key row bhtd", dict(b=1, h=2, kvh=2, t=4096, dh=64, dtype=torch.float32, causal=False,
                                       masked=False, layout="bhtd", full_mask_rows=False)),
        # Workload B's training (phase 9): GRPO's forwards over a group of 8,
        # a support ticket bucketed to 224 tokens plus 48 completion tokens
        _grpo_attention_case(),
        # Workload B on a (data, model) mesh (phase 11): one rank's Qwen3-14B
        # heads under tensor parallelism 2 (20 query heads over 4 KV heads),
        # the GRPO passes at 272 tokens and the rollout prefill at 224
        ("qwen3-14b grpo tp2 shard packed gqa causal+mask, left-padded", dict(
            b=8, h=20, kvh=4, t=272, dh=128, dtype=torch.bfloat16, causal=True, masked=True, layout="packed",
            full_mask_rows=True, left_padded=True)),
        ("qwen3-14b rollout prefill tp2 shard packed gqa causal+mask, left-padded", dict(
            b=8, h=20, kvh=4, t=224, dh=128, dtype=torch.bfloat16, causal=True, masked=True, layout="packed",
            full_mask_rows=True, left_padded=True)),
        # entry()'s forward step (phase 13): ViT-L over its 8 example images
        ("vit-l b8 packed, entry()", dict(b=8, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                                          layout="packed", full_mask_rows=False)),
    ]


def attention_qkv_cases() -> list[tuple[str, dict]]:
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("vit-l b64 stacked", dict(b=64, h=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                                   full_mask_rows=False)),
        ("clip text b128 stacked causal+mask", dict(b=128, h=12, t=77, dh=64, dtype=bf16, causal=True, masked=True,
                                                    full_mask_rows=False)),
        ("siglip-448 b8 stacked", dict(b=8, h=16, t=1024, dh=72, dtype=bf16, causal=False, masked=False,
                                       full_mask_rows=False)),
        ("f32 stacked causal+mask, fully masked rows", dict(b=4, h=4, t=77, dh=64, dtype=f32, causal=True,
                                                            masked=True, full_mask_rows=True)),
        ("vit-l b64 stacked f32", dict(b=64, h=16, t=577, dh=64, dtype=f32, causal=False, masked=False,
                                       full_mask_rows=False)),
    ]


def _grpo_attention_case():
    import torch

    return ("qwen3-14b grpo packed gqa causal+mask, left-padded", dict(
        b=8, h=40, kvh=8, t=272, dh=128, dtype=torch.bfloat16, causal=True, masked=True, layout="packed",
        full_mask_rows=True, left_padded=True))


# the --layer-impl fused encoder layer: ViT-L b64 (M 64*577), CLIP text b128
# (M 128*77), ColPali's SigLIP-448 b8 (M 8*1024, LayerNorm eps 1e-6)
VIT_ROWS, TEXT_ROWS, SIGLIP_ROWS = 64 * 577, 128 * 77, 8 * 1024


def prologue_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    vit, txt, sig = VIT_ROWS, TEXT_ROWS, SIGLIP_ROWS
    return [
        ("vit-l b64 qkv", dict(m=vit, d=1024, n=3072, dtype=bf16, has_delta=True, act=None)),
        ("vit-l b64 mlp", dict(m=vit, d=1024, n=4096, dtype=bf16, has_delta=True, act="quick_gelu")),
        ("clip text b128 qkv", dict(m=txt, d=768, n=2304, dtype=bf16, has_delta=True, act=None)),
        ("clip text b128 mlp", dict(m=txt, d=768, n=3072, dtype=bf16, has_delta=True, act="quick_gelu")),
        ("siglip-448 b8 mlp", dict(m=sig, d=1152, n=4304, dtype=bf16, has_delta=True, act="gelu_pytorch_tanh",
                                   eps=1e-6)),
        ("vit-h b32 mlp", dict(m=32 * 257, d=1280, n=5120, dtype=bf16, has_delta=True, act="gelu")),
        ("first sublayer, no delta (vit-l b64 qkv)", dict(m=vit, d=1024, n=3072, dtype=bf16, has_delta=False,
                                                          act=None)),
        ("rms_gemma", dict(m=4096, d=2048, n=1024, dtype=bf16, has_delta=True, act=None, norm="rms_gemma",
                           eps=1e-6)),
        ("f32 odd M and N", dict(m=77, d=64, n=37, dtype=torch.float32, has_delta=True, act="gelu")),
    ]


def layernorm_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    return [
        ("vit-l b64 rows", dict(m=VIT_ROWS, d=1024, dtype=bf16, eps=1e-5)),
        ("siglip-448 b8 rows", dict(m=SIGLIP_ROWS, d=1152, dtype=bf16, eps=1e-6)),
        ("f32", dict(m=1000, d=768, dtype=torch.float32, eps=1e-5)),
    ]


def activation_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    # fc1's output at the benchmark cells' batches: ViT-L b32 at 577 tokens,
    # CLIP text b128 at 77, So400m b32 at 729, SigLIP text b128 at 64; ViT-H
    # b32 at 257 (erf GELU); a ragged f32 one
    return [
        ("clip-l vision b32", dict(m=32 * 577, n=4096, act="quick_gelu", dtype=bf16)),
        ("clip text b128", dict(m=128 * 77, n=3072, act="quick_gelu", dtype=bf16)),
        ("siglip vision b32", dict(m=32 * 729, n=4304, act="gelu_pytorch_tanh", dtype=bf16)),
        ("siglip text b128", dict(m=128 * 64, n=4304, act="gelu_pytorch_tanh", dtype=bf16)),
        ("vit-h b32", dict(m=32 * 257, n=5120, act="gelu", dtype=bf16)),
        ("f32 ragged", dict(m=77, n=3071, act="quick_gelu", dtype=torch.float32)),
    ]


def moe_glue_cases() -> list[tuple[str, dict]]:
    # colpali-kimi-vl-a3b.coco-maxsim's page batch: 8 pages of 1030 tokens,
    # top-6 of 64 experts of width 1408, 2 shared, the dense layer's 11264
    n = 8 * 1030
    return [
        ("routed swiglu", dict(op="swiglu", m=6 * n, width=2 * 1408)),
        ("shared swiglu", dict(op="swiglu", m=n, width=2 * 2 * 1408)),
        ("dense swiglu", dict(op="swiglu", m=n, width=2 * 11264)),
        ("combine", dict(op="combine", n=n, k=6, d=2048)),
        # colpali-granite-4.0-h-small.coco-maxsim-hybrid's page batch: top-10
        # of 72 experts at width 4096, the kernel's 16-choice build
        ("granite combine k10", dict(op="combine", n=n, k=10, d=4096, router="granite")),
        ("ColPali-KimiVL-A3B caption graph", dict(op="graph")),
    ]


def ssm_cases() -> list[tuple[str, dict]]:
    # colpali-granite-4.0-h-small.coco-maxsim-hybrid: a page batch (8 pages
    # of 1030 tokens), its T2I caption batch (32 captions) and an I2T one
    # (128, the engine's text batch) at about 20 tokens, on the chunked body;
    # a ragged f32 one on the recurrent body; two pages whose decays sit near
    # 1; then the whole decoder's launches
    return [
        ("granite page batch", dict(op="scan", b=8, t=1030)),
        ("granite t2i caption batch", dict(op="scan", b=32, t=20)),
        ("granite i2t caption batch", dict(op="scan", b=128, t=20)),
        ("f32 ragged", dict(op="scan", b=3, t=37, dtype="float32")),
        ("near-1 decays", dict(op="scan", b=2, t=1030, near_one=True)),
        ("ColPali-Granite-4.0-H-Small page and caption graph", dict(op="graph")),
    ]


def kda_cases() -> list[tuple[str, dict]]:
    # colpali-kimi-linear-48b-a3b.coco-maxsim-kda: a page batch (8 pages of
    # 1030 tokens, two checked), its T2I caption batch (32 captions) and an
    # I2T one (128, the engine's text batch) at about 20 tokens; a ragged f32
    # one; then the whole decoder's launches
    return [
        ("kimi-linear page batch", dict(b=8, t=1030, check_rows=2)),
        ("kimi-linear t2i caption batch", dict(b=32, t=20)),
        ("kimi-linear i2t caption batch", dict(b=128, t=20, check_rows=16)),
        ("f32 ragged", dict(b=3, t=37, dtype="float32")),
        ("ColPali-Kimi-Linear-48B-A3B page and caption graph", dict(op="graph")),
    ]


def preprocess_cases() -> list[tuple[str, dict]]:
    cases = [(f"OpenAI-CLIP-L shortest_edge {h}x{w}->336", dict(h=h, w=w, b=64))
             for (h, w) in ((480, 640), (640, 480), (480, 480), (427, 640))]
    cases.append(("ColPali-v1.3 exact 480x640->448", dict(h=480, w=640, b=8, model="ColPali-v1.3")))
    # the other models' recipes (MetaCLIP-H14's is LAION-CLIP-H's)
    for model, recipe, size in (("LAION-CLIP-H", "shortest_edge", 224), ("Apple-DFN5B-H", "shortest_edge", 378),
                                ("SigLIP-400M", "exact", 384), ("Jina-CLIP-v1", "exact bicubic", 224)):
        cases.append((f"{model} {recipe} 480x640->{size}", dict(h=480, w=640, b=32, model=model)))
    cases.append(("OpenAI-CLIP-L shortest_edge 480x640->336 b8, entry()", dict(h=480, w=640, b=8)))
    return cases


def maxsim_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    return [
        ("colpali t2i", dict(nq=128, tq=32, nd=128, td=1030, dim=128, dtype=bf16, masked=False)),
        ("colpali i2t", dict(nq=128, tq=1030, nd=640, td=32, dim=128, dtype=bf16, masked=False)),
        ("masked padding edges", dict(nq=37, tq=45, nd=29, td=75, dim=128, dtype=bf16, masked=True)),
        ("f32 masked padding edges", dict(nq=37, tq=45, nd=29, td=75, dim=128, dtype=torch.float32,
                                          masked=True)),
        # a fifth of COCO-5k's I2T (1000 images x 5000 captions, rounded up):
        # 44.2 TFLOP, 45 ms at the bound; the first 64 queries checked
        ("coco-5k fifth i2t", dict(nq=1024, tq=1030, nd=5120, td=32, dim=128, dtype=bf16, masked=False,
                                   check_queries=64)),
        # cli/search.py at search size: 64 queries of 32 tokens against a
        # COCO-5k-sized f32 ColPali index (2.64 GB; 2.70 TFLOP, 40 ms at the
        # f32 bound); the first 4 queries checked
        ("f32 search-sized", dict(nq=SEARCH_QUERIES_N, tq=32, nd=SEARCH_DOCS, td=1030, dim=128,
                                  dtype=torch.float32, masked=False, check_queries=4)),
    ]


# --cases names: (case list, the function that runs one case, its print tag)
CASE_SETS = {
    "activation": (activation_cases, "_activation_case", "activation"),
    "moe_glue": (moe_glue_cases, "_moe_glue_case", "moe_glue"),
    "ssm": (ssm_cases, "_ssm_case", "ssm"),
    "kda": (kda_cases, "_kda_case", "kda"),
    "preprocess": (preprocess_cases, "_preprocess_case", "preprocess"),
    "maxsim": (maxsim_cases, "_maxsim_case", "maxsim"),
    "attention": (attention_cases, "_attention_case", "attention"),
    "attention_qkv": (attention_qkv_cases, "_attention_qkv_case", "attention_qkv"),
    "prologue": (prologue_cases, "_prologue_case", "prologue"),
    "layernorm": (layernorm_cases, "_layer_norm_case", "layernorm"),
}


def run_cases(names: list[str]) -> int:
    """``--cases a,b``: the build, then those sets of phase 2's cases alone,
    each printed; a case that fails is printed with its error and the run
    exits 1, with no result line. A copy of this script placed in another
    checkout of the port times that checkout's kernels at the same shapes."""
    unknown = [n for n in names if n not in CASE_SETS]
    if unknown or not names:
        print(f"chip_smoke: --cases takes a comma-separated list of {sorted(CASE_SETS)}, not {names}",
              file=sys.stderr)
        return 2
    phase_build()
    rng = np.random.default_rng(0)
    failed = 0
    for set_name in names:
        cases, fn_name, tag = CASE_SETS[set_name]
        for name, kw in cases():
            try:
                globals()[fn_name](name, **kw, rng=rng)
            except RuntimeError as e:
                failed += 1
                print(f"[{tag}] {json.dumps({'case': name, 'error': str(e)})}")
    return 1 if failed else 0


def phase_kernels() -> list[dict]:
    import torch

    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    attn = [_attention_case(name, **kw, rng=rng) for name, kw in attention_cases()]
    grpo = _grpo_attention_case()[1]
    attn.append(_attention_grad_case("qwen3-14b grpo backward", b=grpo["b"], h=grpo["h"], kvh=grpo["kvh"],
                                     t=grpo["t"], dh=grpo["dh"], rng=rng))
    pre = [_preprocess_case(name, **kw, rng=rng) for name, kw in preprocess_cases()]
    maxsim = [_maxsim_case(name, **kw, rng=rng) for name, kw in maxsim_cases()]
    torch.cuda.empty_cache()
    prologue = [_prologue_case(name, **kw, rng=rng) for name, kw in prologue_cases()]
    attn_qkv = [_attention_qkv_case(name, **kw, rng=rng) for name, kw in attention_qkv_cases()]
    ln = [_layer_norm_case(name, **kw, rng=rng) for name, kw in layernorm_cases()]
    act = [_activation_case(name, **kw, rng=rng) for name, kw in activation_cases()]
    torch.cuda.empty_cache()
    moe = [_moe_glue_case(name, **kw, rng=rng) for name, kw in moe_glue_cases()]
    moe_swiglu = [c for c in moe if c["op"] == "swiglu"]
    moe_combine = [c for c in moe if c["op"] == "combine"]
    (moe_graph,) = [c for c in moe if c["op"] == "graph"]
    torch.cuda.empty_cache()
    ssm = [_ssm_case(name, **kw, rng=rng) for name, kw in ssm_cases()]
    (ssm_graph,) = [c for c in ssm if c["op"] == "graph"]
    torch.cuda.empty_cache()
    kda = [_kda_case(name, **kw, rng=rng) for name, kw in kda_cases()]
    (kda_graph,) = [c for c in kda if c["op"] == "graph"]
    root = "multimodal_embedding_tpu_torch/csrc"
    # the f32 bodies are kernels of their own (flash_f32_kernel, tf32x3_kernel)
    # with their own launch counts: their cases and headlines apart
    attn_f32 = [c for c in attn if c.get("dtype") == "float32"]
    attn = [c for c in attn if c.get("dtype") != "float32"]
    maxsim_f32 = [c for c in maxsim if c["dtype"] == "float32"]
    maxsim = [c for c in maxsim if c["dtype"] != "float32"]
    return [
        {"name": "fused_attention", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:219", **_headline(attn[0]),
         "cases": attn},
        {"name": "fused_attention_f32", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:219",
         "path": "f32 calls of fused_attention: Workload B's f32 decoders", **_headline(_case(attn_f32, "qwen3-14b f32")),
         "cases": attn_f32},
        {"name": "preprocess", "route": "cuda", "source": f"{root}/preprocess.cu",
         "replaces": "multimodal_embedding_tpu/ops/preprocess_pallas.py:57", **_headline(pre[0]),
         "cases": pre},
        {"name": "maxsim", "route": "cuda", "source": f"{root}/maxsim.cu",
         "replaces": "multimodal_embedding_tpu/ops/maxsim.py:128", **_headline(maxsim[0]),
         "cases": maxsim},
        {"name": "maxsim_f32", "route": "cuda", "source": f"{root}/maxsim.cu",
         "replaces": "multimodal_embedding_tpu/ops/maxsim.py:128",
         "path": "f32 calls of maxsim_cuda: every search of an f32 index", **_headline(_case(maxsim_f32, "f32 search")),
         "cases": maxsim_f32},
        {"name": "fused_res_norm_matmul", "route": "cuda", "source": f"{root}/fused_ln_matmul.cu",
         "replaces": "multimodal_embedding_tpu/ops/fused_ln_matmul.py:167", **_headline(prologue[0]),
         "cases": prologue},
        {"name": "fused_attention_qkv", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:399", **_headline(attn_qkv[0]),
         "cases": attn_qkv},
        {"name": "fused_layer_norm", "route": "cuda", "source": f"{root}/layernorm.cu",
         "replaces": "multimodal_embedding_tpu/ops/layernorm_pallas.py:38",
         "path": "none (no path in the JAX package)", **_headline(ln[0]), "cases": ln},
        {"name": "mlp_activation", "route": "cuda", "source": f"{root}/activation.cu",
         "replaces": "XLA's fusion of multimodal_embedding_tpu/models/layers.py:425 (no Pallas kernel)",
         **_headline(act[0]), "cases": act},
        {"name": "moe_swiglu", "route": "cuda", "source": f"{root}/moe.cu",
         "replaces": "none (the JAX package has no MoE layer): ops/moe.py:swiglu_plain's ATen chain",
         "path": "the ColPali-KimiVL-A3B and ColPali-Granite-4.0-H-Small decoders", **_headline(moe_swiglu[0]),
         "cases": moe_swiglu},
        {"name": "moe_combine", "route": "cuda", "source": f"{root}/moe.cu",
         "replaces": "none (the JAX package has no MoE layer): the index_put, f32 product, sum and add of ops/moe.py",
         "path": "the ColPali-KimiVL-A3B and ColPali-Granite-4.0-H-Small decoders", **_headline(moe_combine[0]),
         "cases": [*moe_combine, moe_graph]},
        {"name": "ssm_scan", "route": "cuda", "source": f"{root}/ssm.cu",
         "replaces": "none (the JAX package has no state-space layer): ops/ssm.py:scan_plain, the chunked f32 form",
         "path": "the ColPali-Granite-4.0-H-Small decoder", **_headline(ssm[0]),
         "launches": ssm_graph["caption"]["eager"]["ssm_scan"], "cases": ssm},
        {"name": "kda_scan", "route": "cuda", "source": f"{root}/kda.cu",
         "replaces": "none (the JAX package has no linear-attention layer): ops/kda.py:kda_plain, the chunked f32 form",
         "path": "the ColPali-Kimi-Linear-48B-A3B decoder", **_headline(kda[0]),
         "launches": kda_graph["caption"]["eager"]["kda_scan"], "cases": kda},
    ]


def _case(cases: list[dict], prefix: str) -> dict:
    return next(c for c in cases if c["case"].startswith(prefix))


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"launches": 0, **{k: case[k] for k in keys}}


# --- phase 3 -------------------------------------------------------------------


def _main_path(args: list[str], csv_name: str, names_for) -> list[dict]:
    """Run the port's CLI in-process. For each model it runs, every launch
    count is set to 0 just before its benchmark and read just after, and
    every kernel that ``names_for(model)`` names must have launched. Returns
    one dict a model, in the CLI's order: its CSV ``row``, its ``counts``, the
    shapes and finiteness of the score matrices it built (``scores``), its
    peak device memory (``peak_bytes``; the CLI resets the peak as each
    model begins) and the device memory in use as it began to load
    (``in_use_before_load``)."""
    import pandas as pd
    import torch

    from multimodal_embedding_tpu_torch.cli import main as cli
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / csv_name
    out.unlink(missing_ok=True)
    runs: list[dict] = []
    load, bench, compute = cli._load, cli.run_bootstrap_benchmark, cli.compute_score_matrices

    def loading(info, *a, **kw):
        runs.append({"model": info.name, "in_use_before_load": torch.cuda.memory_allocated(), "scores": []})
        return load(info, *a, **kw)

    def benchmarking(*a, **kw):
        reset_launch_counts()
        try:
            return bench(*a, **kw)
        finally:
            runs[-1]["counts"] = launch_counts()
            runs[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()

    def recording(*a, **kw):  # reads the matrices after the timed encode
        s_t2i, s_i2t, t = compute(*a, **kw)
        runs[-1]["scores"].extend((tuple(s.shape), bool(s.isfinite().all())) for s in (s_t2i, s_i2t))
        return s_t2i, s_i2t, t

    cli._load, cli.run_bootstrap_benchmark, cli.compute_score_matrices = loading, benchmarking, recording
    try:
        rc = cli.main([*args, "--output", str(out)])
    finally:
        cli._load, cli.run_bootstrap_benchmark, cli.compute_score_matrices = load, bench, compute
    require(rc == 0, f"main path CLI {args} exited {rc}")
    df = pd.read_csv(out)
    require(list(df.columns) == REFERENCE_COLUMNS, f"CSV columns {list(df.columns)}")
    require(list(df["Model"]) == [r["model"] for r in runs], f"CSV rows {list(df['Model'])} for {runs}")
    for (_, row), run in zip(df.iterrows(), runs):
        for col in REFERENCE_COLUMNS[2:-5]:
            val = float(row[col])
            require(math.isfinite(val) and (0.0 <= val <= 100.0 or col.endswith("_std")), f"{col} = {val}")
        require(float(row["QPS"]) > 0, f"QPS {row['QPS']}")
        counts = run["counts"]
        for n in names_for(run["model"]):
            require(counts[n] > 0, f"kernel {n} was not launched on the {row['Model']} main path")
        run["row"] = row
        print(f"[main] {row['Model']} weights={row['Weights']} QPS={float(row['QPS'])} "
              f"Encoding_Time={float(row['Encoding_Time'])} Time={float(row['Time'])} "
              f"Time-Encoding_Time={float(row['Time']) - float(row['Encoding_Time'])} "
              f"T2I_R@1={float(row['T2I_R@1_mean'])} T2I_R@10={float(row['T2I_R@10_mean'])} "
              f"I2T_R@10={float(row['I2T_R@10_mean'])} peak_memory_bytes={run['peak_bytes']} "
              f"in_use_before_load={run['in_use_before_load']} launches={json.dumps(counts)} "
              f"scores={run['scores']}")
    return runs


def _kimi_main_path() -> tuple[dict, int]:
    """``ColPali-KimiVL-A3B`` through the CLI (``_main_path``): its run and
    the decoder forwards of its benchmark, every ``encode_image`` and
    ``encode_text`` call of the model (the caption batches' graph replays
    among them), counted in the window of its launch counts."""
    from multimodal_embedding_tpu_torch.cli import main as cli
    from multimodal_embedding_tpu_torch.models.colpali import ColPali

    forwards = [0]
    image, text, bench = ColPali.encode_image, ColPali.encode_text, cli.run_bootstrap_benchmark

    def counting(fn):
        def call(self, *a, **kw):
            forwards[0] += 1
            return fn(self, *a, **kw)
        return call

    def benchmarking(*a, **kw):  # inside _main_path's reset of the launch counts
        forwards[0] = 0
        return bench(*a, **kw)

    ColPali.encode_image, ColPali.encode_text = counting(image), counting(text)
    cli.run_bootstrap_benchmark = benchmarking
    try:
        (kimi,) = _main_path(KIMI_CLI_ARGS, "kimi.csv", lambda m: ("moe_swiglu", "moe_combine", "grouped_mm"))
    finally:
        ColPali.encode_image, ColPali.encode_text, cli.run_bootstrap_benchmark = image, text, bench
    return kimi, forwards[0]


def phase_main_path(kernels: list[dict]) -> None:
    import torch

    (clip,) = _main_path(CLI_ARGS, "main_path.csv", lambda m: ("fused_attention", "preprocess"))
    clip_row, clip_counts = clip["row"], clip["counts"]
    torch.cuda.empty_cache()
    (colpali,) = _main_path(COLPALI_CLI_ARGS, "colpali.csv", lambda m: ("fused_attention", "preprocess", "maxsim"))
    row, counts, scores = colpali["row"], colpali["counts"], colpali["scores"]
    n = 128
    want = [((n, n), True), ((n, 5 * n), True)]
    require(scores == want, f"ColPali score matrices {scores}, want {want} (shape, all finite)")
    # the NaN-poisoned scores of a zero-pad / eps-free normalization give
    # R@10 = 100 with random weights
    require(float(row["T2I_R@10_mean"]) < 100.0, f"ColPali T2I R@10 {row['T2I_R@10_mean']}")
    torch.cuda.empty_cache()
    (fused,) = _main_path([*CLI_ARGS, "--layer-impl", "fused"], "main_path_fused.csv",
                          lambda m: ("fused_res_norm_matmul", "fused_attention_qkv", "preprocess"))
    fused_row, fused_counts = fused["row"], fused["counts"]
    # every encoder layer of both towers: one stacked-QKV attention where the
    # xla layer ran one fused_attention, and two prologues (24 x 2 per image
    # batch, 12 x 2 per text batch)
    layer_runs = clip_counts["fused_attention"]
    # one MLP activation an encoder layer on the xla path; the fused path's
    # is in the prologue's epilogue
    require(clip_counts["mlp_activation"] == layer_runs, f"xla path launches {clip_counts}")
    require(fused_counts["fused_attention_qkv"] == layer_runs and fused_counts["fused_attention"] == 0
            and fused_counts["fused_res_norm_matmul"] == 2 * layer_runs and fused_counts["mlp_activation"] == 0,
            f"fused path launches {fused_counts}, want {layer_runs} encoder layers")
    print(f"[main] OpenAI-CLIP-L QPS: --layer-impl xla {float(clip_row['QPS'])}, "
          f"--layer-impl fused {float(fused_row['QPS'])} (same script run); fused launches "
          f"prologue {fused_counts['fused_res_norm_matmul']}, stacked-QKV attention "
          f"{fused_counts['fused_attention_qkv']}, preprocess {fused_counts['preprocess']}")
    torch.cuda.empty_cache()
    # the other five models: attention and preprocess on the ViT-H and SigLIP
    # paths; Jina's towers keep their attention inline (no kernel route in
    # the JAX package either), so preprocess alone
    others = _main_path(OTHER_CLI_ARGS, "other_models.csv",
                        lambda m: ("preprocess",) if m == "Jina-CLIP-v1" else ("fused_attention", "preprocess"))
    require([r["model"] for r in others] == list(OTHER_MODELS), f"models run {[r['model'] for r in others]}")
    base = others[0]["in_use_before_load"]  # the staged images alone
    for r in others:
        require(r["scores"] == want, f"{r['model']} score matrices {r['scores']}, want {want}")
        # each model's weights and activations were released before the next
        # loaded (the margin: cuBLAS workspaces the first model allocated)
        require(r["in_use_before_load"] <= base + (256 << 20),
                f"{r['model']}: {r['in_use_before_load']} bytes in use as it began to load, {base} before the first")
    jina = others[-1]["counts"]
    require(jina["fused_attention"] == 0 and jina["mlp_activation"] == 0,
            f"Jina-CLIP-v1 launched the attention or MLP activation kernel: {jina}")
    print("[main] other models: " + "; ".join(
        f"{r['model']} QPS={float(r['row']['QPS'])} peak_memory_GB={r['peak_bytes'] / 1e9:.3f} "
        f"attention={r['counts']['fused_attention']} preprocess={r['counts']['preprocess']} "
        f"mlp_activation={r['counts']['mlp_activation']}" for r in others))
    torch.cuda.empty_cache()
    # the MoE decoder: 53 moe_swiglu (26 routed, 26 shared, dense layer 0) and
    # 26 moe_combine a forward; none on any other path
    kimi, forwards = _kimi_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    kimi_counts = kimi["counts"]
    kimi_want = {"moe_swiglu": 53 * forwards, "moe_combine": 26 * forwards, "grouped_mm": 52 * forwards}
    require(forwards > 0 and {key: kimi_counts[key] for key in kimi_want} == kimi_want,
            f"ColPali-KimiVL-A3B main path: launches {kimi_counts}, want {kimi_want} ({forwards} decoder forwards)")
    require(torch.cuda.memory_allocated() < base + (1 << 30),
            f"ColPali-KimiVL-A3B left {torch.cuda.memory_allocated()} bytes in use")
    print(f"[main] ColPali-KimiVL-A3B QPS={float(kimi['row']['QPS'])} peak_memory_GB={kimi['peak_bytes'] / 1e9:.3f} "
          f"decoder_forwards={forwards} moe_swiglu={kimi_counts['moe_swiglu']} "
          f"moe_combine={kimi_counts['moe_combine']} grouped_mm={kimi_counts['grouped_mm']}")
    paths = {"OpenAI-CLIP-L": clip_counts, "ColPali-v1.3": counts, "OpenAI-CLIP-L fused": fused_counts,
             **{r["model"]: r["counts"] for r in others}}
    for name in ("moe_swiglu", "moe_combine", "grouped_mm", "ssm_scan", "kda_scan"):
        require(all(c[name] == 0 for c in paths.values()), f"{name} launched off the MoE decoders: {paths}")
    require(kimi_counts["ssm_scan"] == 0 and kimi_counts["kda_scan"] == 0,
            f"ColPali-KimiVL-A3B launched a scan: {kimi_counts}")
    paths["ColPali-KimiVL-A3B"] = kimi_counts
    for k in kernels:
        if k["name"] in ("ssm_scan", "kda_scan"):  # the hybrid decoders' launches are phase 2's forwards
            k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
            continue
        # each kernel's launches on the path that runs it: ColPali for
        # attention, preprocess and MaxSim, the fused CLIP-L path for the
        # prologue and stacked-QKV attention, CLIP-L for the MLP activation,
        # ColPali-KimiVL-A3B for the MoE SwiGLU and combine; no path runs
        # fused_layer_norm (0)
        path = (fused_counts if k["name"] in ("fused_res_norm_matmul", "fused_attention_qkv", "fused_layer_norm")
                else clip_counts if k["name"] == "mlp_activation"
                else kimi_counts if k["name"] in ("moe_swiglu", "moe_combine") else counts)
        k["launches"] = path[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    torch.cuda.empty_cache()


# --- phases 4 and 5 ----------------------------------------------------------------


def phase_bench_and_consistency() -> None:
    import copy

    import torch

    from multimodal_embedding_tpu_torch import bench, runtime
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    line = bench.run_once(dev)  # the port bench's own measurement
    require(line["metric"] == bench.METRIC and line["value"] > 0, f"bench line {line}")
    print(f"[bench] {json.dumps(line)} batch={bench.BATCH} images={bench.N_IMAGES} passes={bench.PASSES} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)} card={card_line()}")

    model = bench.bench_model(dev)
    engine = EncodingEngine(model, batch_size=8, device=dev, preprocess_impl="auto")
    images = bench.bench_images(8)
    # phase 5: the bench's weights, kernels in bf16 (both layer impls) vs plain versions in f32
    emb_kernel = engine.encode_images(images).embeddings
    with runtime.using(layer="fused"):
        emb_fused = engine.encode_images(images).embeddings
    model32 = copy.copy(model)
    model32.model = copy.deepcopy(model.model).float()
    emb_plain = _encode(model32, images, plain=True)[0]  # the unmasked vision tower: the kernels' plain functions
    cos = torch.nn.functional.cosine_similarity(emb_kernel.float(), emb_plain.float(), dim=-1)
    print(f"[consistency] per-image cosine kernel-bf16 vs plain-f32: {[round(float(c), 6) for c in cos]}")
    require(bool((cos >= COSINE_MIN).all()), f"cosine {float(cos.min())} < {COSINE_MIN}")
    cos_f = torch.nn.functional.cosine_similarity(emb_fused.float(), emb_plain.float(), dim=-1)
    cos_fx = torch.nn.functional.cosine_similarity(emb_fused.float(), emb_kernel.float(), dim=-1)
    print(f"[consistency] per-image cosine --layer-impl fused kernel-bf16 vs plain-f32: "
          f"{[round(float(c), 6) for c in cos_f]}; vs the xla-layer kernel-bf16 run: "
          f"{[round(float(c), 6) for c in cos_fx]}")
    require(bool((cos_f >= COSINE_MIN).all()), f"fused cosine {float(cos_f.min())} < {COSINE_MIN}")
    # --attention-impl flash: the unmasked vision tower on the same kernel, no key mask
    with runtime.using(attention="flash"):
        emb_flash = engine.encode_images(images).embeddings
    cos_fl = torch.nn.functional.cosine_similarity(emb_flash.float(), emb_plain.float(), dim=-1)
    print(f"[consistency] per-image cosine --attention-impl flash kernel-bf16 vs plain-f32: "
          f"{[round(float(c), 6) for c in cos_fl]}; bit-equal to the auto run: {bool(torch.equal(emb_flash, emb_kernel))}")
    require(bool((cos_fl >= COSINE_MIN).all()), f"flash cosine {float(cos_fl.min())} < {COSINE_MIN}")


CAPTIONS = ["a dog", "two people riding bicycles along a river at sunset",
            "a red car parked next to a tall building on a busy street", "kitchen",
            "a plate of food on a wooden table", "a man holding an umbrella in the rain",
            "three zebras standing in a grassy field near some trees", "a clock tower"]


def phase_colpali_consistency() -> None:
    """ColPali-v1.3 at full width, the same random weights: per-token
    embeddings of 2 images and 4 captions through the kernels in bf16 against
    the plain versions in f32 (preprocess "xla", attention "xla")."""
    import copy

    import torch

    from multimodal_embedding_tpu_torch import bench, runtime
    from multimodal_embedding_tpu_torch.models.arch import load_arch_model
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    dev = torch.device("cuda")
    images = bench.bench_images(2)
    captions = CAPTIONS[:4]
    model = load_arch_model("ColPali-v1.3", seed=0, device=dev, dtype=torch.bfloat16)
    engine = EncodingEngine(model, batch_size=2, device=dev, preprocess_impl="auto")
    img_k = engine.encode_images(images).embeddings
    txt_k = engine.encode_texts(captions)
    model32 = copy.copy(model)
    model32.model = copy.deepcopy(model.model).float()
    del model, engine
    with runtime.using(attention="xla"):
        plain = EncodingEngine(model32, batch_size=2, device=dev, preprocess_impl="xla")
        img_p = plain.encode_images(images).embeddings
        txt_p = plain.encode_texts(captions)
    del model32, plain
    torch.cuda.empty_cache()

    valid = txt_k.mask.bool()
    require(bool((txt_p.mask.bool() == valid).all()), "ColPali text masks differ")
    for name, emb in (("kernel", txt_k.embeddings), ("plain", txt_p.embeddings)):
        require(bool((emb[~valid] == 0).all()), f"ColPali {name} pad tokens are not exact zeros")
        require(bool(emb.float().isfinite().all()), f"ColPali {name} embeddings not finite")
    cos_img = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(), dim=-1)  # [2, 1030]
    cos_txt = torch.nn.functional.cosine_similarity(txt_k.embeddings.float(), txt_p.embeddings.float(), dim=-1)[valid]
    print(f"[consistency] ColPali per-token cosine kernel-bf16 vs plain-f32: images min "
          f"{float(cos_img.min())} mean {float(cos_img.mean())} over {cos_img.numel()} tokens; texts min "
          f"{float(cos_txt.min())} mean {float(cos_txt.mean())} over {cos_txt.numel()} valid tokens; "
          f"pad tokens {int((~valid).sum())} exact zeros in both")
    worst = min(float(cos_img.min()), float(cos_txt.min()))
    require(worst >= COLPALI_COSINE_MIN, f"ColPali per-token cosine {worst} < {COLPALI_COSINE_MIN}")


def phase_other_models_consistency() -> None:
    """The other five models at full width, the same random weights: pooled
    embeddings of 8 images and 8 captions through the kernels in bf16 (ViT-H
    and SigLIP under both layer impls: the prologue at D 1280 with gelu and
    quick_gelu, D 1152 with gelu_pytorch_tanh; Jina on its own path) against
    the plain versions in f32 (preprocess "xla", attention "xla"), per-row
    cosine >= 0.999."""
    import copy

    import torch

    from multimodal_embedding_tpu_torch import bench
    from multimodal_embedding_tpu_torch.models.arch import load_arch_model

    dev = torch.device("cuda")
    images = bench.bench_images(8)
    for name in OTHER_MODELS:
        model = load_arch_model(name, seed=0, device=dev, dtype=torch.bfloat16)
        impls = ("xla",) if name == "Jina-CLIP-v1" else ("xla", "fused")
        kernel = {impl: _encode(model, images, impl) for impl in impls}
        model32 = copy.copy(model)
        model32.model = copy.deepcopy(model.model).float()
        del model
        img_p, txt_p = _encode(model32, images, plain=True)
        del model32
        torch.cuda.empty_cache()
        for impl, (img_k, txt_k) in kernel.items():
            cos_img = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(), dim=-1)
            cos_txt = torch.nn.functional.cosine_similarity(txt_k.embeddings.float(), txt_p.embeddings.float(), dim=-1)
            print(f"[consistency] {name} --layer-impl {impl} pooled cosine kernel-bf16 vs plain-f32: images "
                  f"{[round(float(c), 6) for c in cos_img]}; captions {[round(float(c), 6) for c in cos_txt]}")
            worst = min(float(cos_img.min()), float(cos_txt.min()))
            require(worst >= COSINE_MIN, f"{name} --layer-impl {impl}: cosine {worst} < {COSINE_MIN}")


# --- phase 6: converted checkpoints --------------------------------------------------


@functools.cache
def _normal_pool(seed: int) -> np.ndarray:
    """NORMAL_POOL seeded normals with std 0.02 (2.1 GB, drawn once)."""
    pool = np.random.default_rng(seed).standard_normal(NORMAL_POOL, dtype=np.float32)
    pool *= 0.02
    return pool


class ManifestWeights(Mapping):
    """An HF-layout state dict at full published width: the keys and shapes of
    ``tests/manifests/<name>.json``, each value made as it is read (nothing is
    held: the converter reads each key once, and ColPali's f32 tree alone is
    12 GB). Two ways to make a key's values, both seeded and both a few
    seconds a model where drawing every value takes a minute for ColPali:

    - ``toeplitz`` (the models whose trees go through the native cache): a
      key of shape [R, ...] with C values a row is a random Toeplitz matrix,
      R + C - 1 normals drawn from ``default_rng((seed, crc32(key)))``, the
      value at (i, j) the draw ``j - i + R - 1``. Each row, and each row of
      its transpose, is the row before moved one place along, inside
      deflate's 32 KB window for rows of up to 8125 values, so
      ``save_params`` deflates the converted tree fast where random values
      take minutes.
    - otherwise, a slice of one shared pool of normals (``_normal_pool``) at
      an offset from the key's crc32: within a key the values are
      independent normals (two keys may share some). ColPali needs this: on
      Toeplitz weights ColPali in bf16, the plain path and the kernels
      alike, falls below a mean per-token cosine of 0.999 against f32.

    A transposed or misplaced weight differs from the right one in both.
    LayerNorm scales are near 1, Gemma's RMSNorm weights near 0 (its gain is
    1 + w); every other weight has std 0.02: zeros would hide a layout
    mistake."""

    def __init__(self, name: str, *, toeplitz: bool, seed: int = 0):
        self.shapes = json.loads((MANIFESTS / f"{name}.json").read_text())
        self.toeplitz = toeplitz
        self.seed = seed
        self.draw_seconds = 0.0

    def __getitem__(self, key: str) -> np.ndarray:
        t0 = time.perf_counter()
        shape = self.shapes[key]
        crc = zlib.crc32(key.encode())
        if self.toeplitz:
            rows, cols = (shape[0], math.prod(shape[1:])) if shape else (1, 1)
            diagonals = np.random.default_rng([self.seed, crc]).standard_normal(rows + cols - 1, dtype=np.float32)
            diagonals *= 0.02
            windows = np.lib.stride_tricks.sliding_window_view(diagonals, cols)
            x = windows[::-1].copy()  # row i: diagonals[R - 1 - i :][:C]
        else:
            pool, n = _normal_pool(self.seed), math.prod(shape)
            start = crc * 2654435761 % NORMAL_POOL  # spread the 32-bit crc over the pool
            x = np.concatenate([pool[start:start + n], pool[: max(0, start + n - NORMAL_POOL)]])
        x = x.reshape(shape)
        module = key.split(".")[-2] if "." in key else ""
        if key.endswith(".weight") and ("norm" in module.lower() or module.endswith("_ln")) \
                and "language_model." not in key:
            x += 1.0
        self.draw_seconds += time.perf_counter() - t0
        return x

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


def _convert(name: str) -> tuple[dict, object, float, float]:
    """One model's HF-layout state dict through the port's converter: (tree,
    config, seconds, of which drawing the values)."""
    from multimodal_embedding_tpu_torch.models.arch import full_arch_config, full_colpali_config
    from multimodal_embedding_tpu_torch.models.colpali import colpali_params_from_hf
    from multimodal_embedding_tpu_torch.models.convert import clip_params_from_hf, siglip_params_from_hf
    from multimodal_embedding_tpu_torch.models.jina import jina_config_from_sd, jina_params_from_hf
    from multimodal_embedding_tpu_torch.models.registry import model_info

    kind = model_info(name).type
    sd = ManifestWeights(name, toeplitz=name in CACHED_MODELS)
    t0 = time.perf_counter()
    if kind == "jina":
        cfg = jina_config_from_sd(sd)
        tree = jina_params_from_hf(sd, cfg)
    elif kind == "colpali":
        cfg = full_colpali_config()
        tree = colpali_params_from_hf(sd, cfg, COLPALI_SUFFIX_IDS)
    else:
        cfg = full_arch_config(name)
        tree = (siglip_params_from_hf if kind == "siglip" else clip_params_from_hf)(sd, cfg)
    return tree, cfg, time.perf_counter() - t0, sd.draw_seconds


def _loaded(name: str, tree: dict, cfg, dtype):
    """A ``LoadedModel`` on the card holding the tree's weights in ``dtype``,
    with the offline word-hash tokenizer (no tokenizer files exist)."""
    import torch

    from multimodal_embedding_tpu_torch.models.arch import arch_tokenizer
    from multimodal_embedding_tpu_torch.models.colpali import colpali_from_params
    from multimodal_embedding_tpu_torch.models.jina import jina_from_params
    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.models.zoo import LoadedModel, dual_encoder_from_params

    info = model_info(name)
    build = {"colpali": colpali_from_params, "jina": jina_from_params}.get(info.type, dual_encoder_from_params)
    model = build(tree, cfg, device=torch.device("cuda"), dtype=dtype)
    return LoadedModel(info=info, cfg=cfg, model=model, preprocess=info.preprocess,
                       tokenize=arch_tokenizer(info, cfg), multi_vector=info.type == "colpali")


def _encode(model, images, layer: str = "xla", *, plain: bool = False):
    """``model``'s image embeddings and caption output at batch 8: through
    the kernels under ``layer``, or, ``plain``, through every kernel's plain
    version (preprocess and attention "xla")."""
    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    engine = EncodingEngine(model, batch_size=8, device="cuda", preprocess_impl="xla" if plain else "auto")
    with runtime.using(layer=layer, **({"attention": "xla"} if plain else {})):
        return engine.encode_images(images).embeddings, engine.encode_texts(CAPTIONS)


def _check_colpali(img_k, txt_k, img_p, txt_p) -> None:
    """ColPali's per-token embeddings and MaxSim scores, the kernel path in
    bf16 against the plain path in f32."""
    import torch

    from multimodal_embedding_tpu_torch.retrieval.scoring import late_interaction_scores

    valid = txt_k.mask.bool()
    require(bool((txt_p.mask.bool() == valid).all()), "ColPali text masks differ")
    for which, emb in (("kernel", txt_k.embeddings), ("plain", txt_p.embeddings)):
        require(bool((emb[~valid] == 0).all()), f"converted ColPali {which} pad tokens are not exact zeros")
    cos_img = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(), dim=-1)
    cos_txt = torch.nn.functional.cosine_similarity(txt_k.embeddings.float(), txt_p.embeddings.float(), dim=-1)[valid]
    cos = torch.cat([cos_img.flatten(), cos_txt])
    scores = late_interaction_scores(txt_k.embeddings, img_k, impl="auto")  # the MaxSim kernel
    scores_same = late_interaction_scores(txt_k.embeddings, img_k, impl="xla")
    scores_plain = late_interaction_scores(txt_p.embeddings, img_p, impl="xla")
    kernel_rel = float((scores - scores_same).abs().max() / scores_same.abs().max())
    # unit tokens at cosine c differ by at most sqrt(2(1 - c)), and a query
    # token's max over doc tokens by at most twice that
    bound = 2 * math.sqrt(2 * (1 - COLPALI_COSINE_MIN)) * valid.sum(dim=1, keepdim=True).float()
    path_err = (scores - scores_plain).abs()
    print(f"[converted] ColPali-v1.3 per-token cosine kernel-bf16 vs plain-f32: min {float(cos.min())} mean "
          f"{float(cos.mean())} over {cos.numel()} tokens ({cos_img.numel()} image, {cos_txt.numel()} text); "
          f"pad tokens {int((~valid).sum())} exact zeros; MaxSim {tuple(scores.shape)} kernel vs plain on the same "
          f"embeddings max|d|/max|plain| {kernel_rel}; kernel path vs plain path max|d| {float(path_err.max())} "
          f"(max|plain| {float(scores_plain.abs().max())}, limit {float(bound.min())} a query)")
    require(bool(scores.isfinite().all()), "converted ColPali MaxSim scores not finite")
    require(float(cos.min()) >= COLPALI_COSINE_MIN and float(cos.mean()) >= COSINE_MIN,
            f"converted ColPali per-token cosine min {float(cos.min())}, mean {float(cos.mean())}")
    require(kernel_rel <= MAXSIM_REL_TOL_BF16, f"converted ColPali MaxSim kernel rel err {kernel_rel}")
    require(bool((path_err <= bound).all()), f"converted ColPali MaxSim path error {float(path_err.max())}")


def phase_converted(kernels: list[dict]) -> None:
    """Phase 6 (see the module docstring)."""
    import torch

    from multimodal_embedding_tpu_torch import bench
    from multimodal_embedding_tpu_torch.models import zoo
    from multimodal_embedding_tpu_torch.models.arch import arch_tokenizer, full_arch_config
    from multimodal_embedding_tpu_torch.models.checkpoint import load_params, save_params

    mem = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("[converted] host memory (free -g): " + " | ".join(" ".join(line.split()) for line in mem.splitlines()))
    card = card_line()
    images = bench.bench_images(8)
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as cache_dir:
        direct = {}  # CLIP-L and SigLIP-400M: bf16 kernel embeddings of the directly converted model
        for name in CONVERTED_MODELS:
            tree, cfg, convert_s, draw_s = _convert(name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = _loaded(name, tree, cfg, torch.bfloat16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            impls = ("xla", "fused") if name in CACHED_MODELS else ("xla",)
            kernel = {impl: _encode(model, images, impl) for impl in impls}
            peak = torch.cuda.max_memory_allocated()
            del model
            torch.cuda.empty_cache()
            model32 = _loaded(name, tree, cfg, torch.float32)
            img_p, txt_p = _encode(model32, images, plain=True)
            del model32
            torch.cuda.empty_cache()
            print(f"[converted] {name}: convert {convert_s:.2f} s (drawing the values {draw_s:.2f} s of it), "
                  f"load to the card in bf16 {load_s:.2f} s, peak device memory {peak / 1e9:.3f} GB "
                  f"(load and kernel encode); card {card}")
            if name == "ColPali-v1.3":
                img_k, txt_k = kernel["xla"]
                _check_colpali(img_k, txt_k, img_p, txt_p)
            else:
                for impl, (img_k, txt_k) in kernel.items():
                    cos_img = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(), dim=-1)
                    cos_txt = torch.nn.functional.cosine_similarity(txt_k.embeddings.float(),
                                                                    txt_p.embeddings.float(), dim=-1)
                    print(f"[converted] {name} --layer-impl {impl} pooled cosine kernel-bf16 vs plain-f32: images "
                          f"{[round(float(c), 6) for c in cos_img]}; captions {[round(float(c), 6) for c in cos_txt]}")
                    worst = min(float(cos_img.min()), float(cos_txt.min()))
                    require(worst >= COSINE_MIN, f"converted {name} --layer-impl {impl}: cosine {worst} < {COSINE_MIN}")
            if name in CACHED_MODELS:
                t0 = time.perf_counter()
                save_params(Path(cache_dir) / f"{name}.npz", tree, cfg)
                direct[name] = (kernel["xla"][0], kernel["xla"][1].embeddings, time.perf_counter() - t0)
            del tree, kernel, img_p, txt_p
        # the native cache: the same f32 trees back from disk, the same kernels
        for name, (img_d, txt_d, save_s) in direct.items():
            t0 = time.perf_counter()
            tree, cfg = load_params(Path(cache_dir) / f"{name}.npz")
            read_s = time.perf_counter() - t0
            require(cfg == full_arch_config(name), f"{name}: cached config {cfg}")
            img_c, txt_c = _encode(_loaded(name, tree, cfg, torch.bfloat16), images, "xla")
            size = (Path(cache_dir) / f"{name}.npz").stat().st_size
            equal = bool(torch.equal(img_c, img_d)) and bool(torch.equal(txt_c.embeddings, txt_d))
            print(f"[converted] {name} native cache: save_params {save_s:.2f} s, {size / 1e9:.3f} GB on disk, "
                  f"load_params {read_s:.2f} s; embeddings bit-equal to the directly converted model's: {equal}")
            require(equal, f"{name}: embeddings from the native cache differ from the directly converted model's")
            del tree
            torch.cuda.empty_cache()
        # the CLI's real-checkpoint path: no tokenizer files exist here, so the
        # arch word-hash tokenizer stands in for zoo.hf_tokenizer (a tokenizer
        # only: weights, device and kernels are the CLI's own)
        hf_tokenizer = zoo.hf_tokenizer
        zoo.hf_tokenizer = lambda info: arch_tokenizer(info, full_arch_config(info.name))
        try:
            runs = _main_path([*REAL_CLI_ARGS, "--native-cache-dir", cache_dir], "real_checkpoints.csv",
                              lambda m: ("fused_attention", "preprocess"))
        finally:
            zoo.hf_tokenizer = hf_tokenizer
    n = 128
    want = [((n, n), True), ((n, 5 * n), True)]
    require([r["model"] for r in runs] == list(CACHED_MODELS), f"real-checkpoint CLI ran {[r['model'] for r in runs]}")
    for r in runs:
        require(r["row"]["Weights"] == "real", f"{r['model']}: Weights {r['row']['Weights']}")
        require(r["scores"] == want, f"{r['model']} score matrices {r['scores']}, want {want}")
    print("[converted] CLI --native-cache-dir, no debug flag: " + "; ".join(
        f"{r['model']} Weights={r['row']['Weights']} QPS={float(r['row']['QPS'])} peak_memory_GB="
        f"{r['peak_bytes'] / 1e9:.3f} attention={r['counts']['fused_attention']} "
        f"preprocess={r['counts']['preprocess']}" for r in runs))
    for k in kernels:
        for r in runs:
            k["launches_by_path"][f"{r['model']} real-checkpoint CLI"] = r["counts"][k["name"]]
    # converters, loaders and the cache are numpy and torch alone
    require("transformers" not in sys.modules, "phase 6 imported transformers")
    torch.cuda.empty_cache()


# --- phase 7: the rest of Workload A ------------------------------------------------

STAGING_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "OpenAI-CLIP-L",
    "--sample-size", "256", "--bootstrap-iterations", "100", "--batch-size", "64",
]
MULTI_SEED_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "OpenAI-CLIP-L,ColPali-v1.3",
    "--sample-size", "128", "--runs", "2", "--mrr",
]
SEARCH_QUERIES = ["a dog catching a frisbee", "two people riding bicycles", "a red car", "kitchen"]
WINO_COLUMNS = ("Wino Text", "Wino Image", "Wino Group")


def _staging_checks(dev) -> dict:
    """The stager, the streaming encode and the two transports on the
    engine, at full width on 256 synthetic records: streaming embeddings and
    the stager's assembled cache bit-equal to the cached path's; host
    against device transport, pooled cosine and pixels in uint8 levels."""
    import torch

    from multimodal_embedding_tpu_torch import bench
    from multimodal_embedding_tpu_torch.data.coco import load_benchmark_dataset
    from multimodal_embedding_tpu_torch.models.encode import AsyncImageStager, EncodingEngine, stage_images
    from multimodal_embedding_tpu_torch.ops.preprocess import host_resize_crop, scale_shift
    from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn

    images = [r["image"] for r in load_benchmark_dataset("synthetic", sample_size=256, seed=42)]
    model = bench.bench_model(dev)
    engine = EncodingEngine(model, 64, device=dev, transport="device")
    cache = stage_images(images, 64, dev)
    cached = engine.encode_images_cached(cache)
    stager = AsyncImageStager(images, 64, dev)
    engine.warmup_streaming(stager)
    t0 = time.perf_counter()
    streamed = engine.encode_images_streaming(stager)
    wall = time.perf_counter() - t0
    assembled = stager.wait()
    require(torch.equal(streamed.embeddings, cached.embeddings), "streaming embeddings differ from the cached path's")
    require(all(torch.equal(a[2], b[2]) and a[1] == b[1] for a, b in zip(assembled.groups, cache.groups))
            and len(assembled.groups) == len(cache.groups), "the stager's cache differs from stage_images'")
    out = {"slices": len(stager.slice_plan), "stage_seconds": stager.stage_seconds,
           "streaming_wall_s": wall, "streaming_compute_s": streamed.seconds, "upload_stall_s": wall - streamed.seconds,
           "cached_encode_s": cached.seconds}
    del cache, assembled, stager, cached, streamed
    # host transport against device transport on 32 images
    few = images[:32]
    host = EncodingEngine(model, 64, device=dev, transport="host").encode_images(few).embeddings
    devt = engine.encode_images(few).embeddings
    cos = torch.nn.functional.cosine_similarity(host.float(), devt.float(), dim=-1)
    cfg = model.preprocess
    scale, shift = (torch.from_numpy(v).to(dev) for v in scale_shift(cfg))
    worst = 0
    for im in few:
        h, w = im.shape[:2]
        px = make_preprocess_cuda_fn(cfg, h, w, device=dev)(torch.from_numpy(im.transpose(2, 0, 1).copy())[None].to(dev))
        levels = torch.round((px[0] - shift) / scale)
        crop = torch.from_numpy(host_resize_crop(cfg, im).astype(np.float32)).to(dev)
        worst = max(worst, int((levels - crop).abs().max()))
    out.update(host_vs_device_cosine_min=float(cos.min()), host_vs_device_max_levels=worst)
    require(float(cos.min()) >= COSINE_MIN, f"host vs device transport cosine {float(cos.min())} < {COSINE_MIN}")
    require(worst <= 1, f"host vs device pixels differ by {worst} uint8 levels")
    del model, engine
    torch.cuda.empty_cache()
    return out


def _v28_value(cell) -> float:
    """The mean of a multi_seed "mean ± std" cell (or a plain number)."""
    return float(str(cell).split("±")[0])


def phase_workload_a(kernels: list[dict]) -> None:
    """Phase 7 (see the module docstring)."""
    import pandas as pd
    import torch

    from multimodal_embedding_tpu_torch.analysis import report
    from multimodal_embedding_tpu_torch.cli import analyze, encode_cli, multi_seed, probe
    from multimodal_embedding_tpu_torch.cli import search as search_cli
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts
    from multimodal_embedding_tpu_torch.ops.maxsim_cuda import maxsim_scores_ref
    from multimodal_embedding_tpu_torch.retrieval import search as search_mod

    dev = torch.device("cuda")
    card = card_line()
    t_phase = time.perf_counter()
    dense = lambda m: ("fused_attention", "preprocess")  # noqa: E731
    paths: dict[str, dict] = {}

    # 1. staging and transports: the engine's checks, then the CLI in each mode
    checks = _staging_checks(dev)
    print(f"[phase7] staging on the engine (256 images, 4 geometries, batch 64): {json.dumps(checks)}; card {card}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as score_dir:
        (overlap,) = _main_path([*STAGING_ARGS, "--score-cache-dir", score_dir], "staging_overlap.csv", dense)
        (streaming,) = _main_path([*STAGING_ARGS, "--streaming-encode"], "staging_streaming.csv", dense)
        (host,) = _main_path([*STAGING_ARGS, "--transport", "host", "--no-device-cache"], "transport_host.csv",
                             lambda m: ("fused_attention",))
        # 2. --attention-impl flash
        (flash,) = _main_path([*STAGING_ARGS, "--attention-impl", "flash"], "flash.csv", dense)
        # 3. --score-cache-dir: the overlap run wrote the matrices; this run reads them
        (resumed,) = _main_path([*STAGING_ARGS, "--score-cache-dir", score_dir], "score_cache.csv", lambda m: ())
    require(host["counts"]["preprocess"] == 0, f"--transport host launched the preprocess kernel: {host['counts']}")
    # flash: the vision tower through the kernel (24 a batch of 64), the
    # masked text tower through the plain f32 path
    require(0 < flash["counts"]["fused_attention"] < overlap["counts"]["fused_attention"],
            f"flash attention launches {flash['counts']}, overlap run {overlap['counts']}")
    require(not any(resumed["counts"].values()), f"the score-cache rerun launched kernels: {resumed['counts']}")
    for col in REFERENCE_COLUMNS[2:-5] + ["QPS", "Encoding_Time"]:
        require(float(resumed["row"][col]) == float(overlap["row"][col]),
                f"score-cache rerun {col} {resumed['row'][col]} != {overlap['row'][col]}")
    print("[phase7] CLI OpenAI-CLIP-L, 256 images, batch 64: " + "; ".join(
        f"{name} QPS={float(r['row']['QPS'])} Encoding_Time={float(r['row']['Encoding_Time'])} "
        f"attention={r['counts']['fused_attention']} preprocess={r['counts']['preprocess']}"
        for name, r in (("overlap-staging", overlap), ("streaming-encode", streaming),
                        ("transport-host", host), ("attention-impl-flash", flash))))
    print(f"[phase7] score cache rerun: same metrics and QPS {float(resumed['row']['QPS'])}, "
          f"launches {json.dumps(resumed['counts'])}")
    paths.update({"overlap-staging CLI": overlap["counts"], "streaming-encode CLI": streaming["counts"],
                  "transport-host CLI": host["counts"], "attention-impl-flash CLI": flash["counts"]})
    torch.cuda.empty_cache()

    # 4. the V28 multi-seed CLI with Winoground
    out = OUT_DIR / "v28.csv"
    out.unlink(missing_ok=True)
    scored = []
    scores = multi_seed._scores

    def recording(*a, **kw):
        s = scores(*a, **kw)
        scored.extend((tuple(x.shape), bool(x.isfinite().all())) for x in s)
        return s

    reset_launch_counts()
    multi_seed._scores = recording
    try:
        rc = multi_seed.main([*MULTI_SEED_ARGS, "--output", str(out)])
    finally:
        multi_seed._scores = scores
    v28_counts = launch_counts()
    require(rc == 0, f"multi_seed exited {rc}")
    for n in ("fused_attention", "preprocess", "maxsim"):
        require(v28_counts[n] > 0, f"kernel {n} was not launched by multi_seed: {v28_counts}")
    require(scored and all(f for _, f in scored), f"multi_seed score matrices {scored}")
    df = pd.read_csv(out)
    require(list(df["Model"]) == ["OpenAI-CLIP-L", "ColPali-v1.3"], f"multi_seed rows {list(df['Model'])}")
    for _, row in df.iterrows():
        for col in [c for c in df.columns if "R@" in c] + list(WINO_COLUMNS):
            val = _v28_value(row[col])
            require(math.isfinite(val) and 0.0 <= val <= 100.0, f"multi_seed {row['Model']} {col} = {row[col]}")
    print(f"[phase7] multi_seed {' '.join(MULTI_SEED_ARGS[4:])}: launches {json.dumps(v28_counts)}; " + "; ".join(
        f"{row['Model']} T2I_R@1={row['T2I_R@1']} I2T_R@10={row['I2T_R@10']} Wino={[row[c] for c in WINO_COLUMNS]} "
        f"QPS={row['QPS']}" for _, row in df.iterrows()))
    paths["multi_seed CLI"] = v28_counts
    torch.cuda.empty_cache()

    # 5. encode_cli then search for ColPali: the f32 MaxSim kernel on a multi-vector index
    index_path = OUT_DIR / "colpali_index.npz"
    rc = encode_cli.main(["--model", "ColPali-v1.3", "--dataset", "synthetic", "--arch-models", "--sample-size", "64",
                          "--no-texts", "--output", str(index_path)])
    require(rc == 0, f"encode_cli exited {rc}")
    searched = []
    search = search_mod.Index.search

    def recording_search(self, queries, k=10, query_mask=None):
        ids, top = search(self, queries, k, query_mask)
        searched.append((self, queries, query_mask, ids, top))
        return ids, top

    reset_launch_counts()
    search_mod.Index.search = recording_search
    try:
        rc = search_cli.main(["--index", str(index_path), "--model", "ColPali-v1.3", "--arch-models", "--k", "10",
                              *[a for q in SEARCH_QUERIES for a in ("--query", q)]])
    finally:
        search_mod.Index.search = search
    search_counts = launch_counts()
    require(rc == 0 and len(searched) == 1, f"search exited {rc} after {len(searched)} searches")
    index, queries, qmask, ids, top = searched[0]
    require(index.multi_vector and index.embeddings.dtype == torch.float32, "the ColPali index is not f32 multi-vector")
    require(search_counts["maxsim_f32"] > 0, f"the index search did not launch the f32 MaxSim kernel: {search_counts}")
    plain = maxsim_scores_ref(queries.float(), index.embeddings, q_mask=qmask)
    plain_top, plain_idx = torch.sort(plain, dim=1, descending=True, stable=True)
    plain_ids = index.ids[plain_idx[:, :10].cpu().numpy()]
    require(np.array_equal(ids, plain_ids), f"search top-10 ids {ids.tolist()} != plain {plain_ids.tolist()}")
    err = float(np.abs(top - plain_top[:, :10].cpu().numpy()).max())
    print(f"[phase7] ColPali index search ({tuple(index.embeddings.shape)} f32, {len(SEARCH_QUERIES)} queries): "
          f"top-10 ids equal to the plain path's; max score |d| {err}; launches {json.dumps(search_counts)}")
    paths["ColPali search CLI"] = search_counts
    del searched, index, queries, plain
    torch.cuda.empty_cache()

    # 6. the probe at full width
    rc = probe.main(["--models", "OpenAI-CLIP-L,ColPali-v1.3", "--weights", "arch"])
    require(rc == 0, f"probe --weights arch exited {rc}")
    torch.cuda.empty_cache()

    # 7. the analyzer on phase 3's five-model CSV and its bootstrap sidecar
    # (multi_seed writes the V28 schema and no sidecar, in both packages)
    csv = OUT_DIR / "other_models.csv"
    rc = analyze.main(["--input", str(csv), "--output", str(OUT_DIR / "report.md")])
    require(rc == 0, f"analyze exited {rc}")
    sig, method = report.pairwise_significance(pd.read_csv(csv), "T2I_R@1", report.load_bootstrap_sidecar(csv),
                                               device=dev)
    p = sig.to_numpy()
    require(method.startswith("permutation") and bool(((p >= 0) & (p <= 1)).all()), f"p-values {method}: {p}")
    print(f"[phase7] analyze: {method}; T2I_R@1 p-values {json.dumps(sig.round(6).to_dict())}")

    for k in kernels:
        for name, counts in paths.items():
            k["launches_by_path"][name] = counts[k["name"]]
    root = "multimodal_embedding_tpu_torch/csrc"
    attn = next(k for k in kernels if k["name"] == "fused_attention")
    kernels.append(
        # the same kernel at the same shape (ViT-L b64, no key mask): its
        # numbers are fused_attention's headline case
        {"name": "flash_sdpa", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/models/layers.py:220",
         "path": "--attention-impl flash: unmasked self-attention through ops/attention_cuda.py:fused_attention",
         **{key: attn[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "launches": flash["counts"]["fused_attention"], "launches_by_path": {"attention-impl-flash CLI": flash["counts"]["fused_attention"]}}
    )
    print(f"[phase7] {time.perf_counter() - t_phase:.1f} s")


# --- phase 8: Workload B serving ------------------------------------------------------

VERIFY_TICKETS, VERIFY_BATCH, VERIFY_PROMPT_LEN, VERIFY_NEW = 128, 64, 256, 48
CONSISTENCY_LAYERS = 4  # the full-width Qwen3-14B check's depth
QWEN3_LOGIT_COSINE_MIN = 0.99  # first-token logits, 40 bf16 layers against the plain attention path
VERIFY_CLI_ARGS = ["--model-size", "small", "--baseline", "--dataset-size", "16"]


def _cosines(a, b):
    """Per-row cosine of two [N, D] tensors, in f64."""
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def _write_adapters(model, path: Path, seed: int) -> dict:
    """``lora_init`` adapters (rank 16, alpha 32) with ``b`` drawn at std
    0.02 from the same seeded generator, so the merge is not the identity;
    written as the ``.npz`` the CLIs read (``<target>.a`` / ``<target>.b``)
    when ``path`` is given."""
    import torch

    from multimodal_embedding_tpu_torch.rl.lora import LoraConfig, lora_init

    gen = torch.Generator(device=model.device).manual_seed(seed)
    adapters = lora_init(model, LoraConfig(), generator=gen)
    for ab in adapters.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=model.device) * 0.02
    if path is not None:
        np.savez(path, **{f"{n}.{p}": ab[p].cpu().numpy() for n, ab in adapters.items() for p in ("a", "b")})
    return adapters


def _qwen3_consistency(dev) -> dict:
    """QWEN3_14B at full width cut to 4 layers (untied head): the prefill's
    hidden states at valid positions and the first-token logits, the kernels
    in bf16 against the plain attention path in f32 on the same weights."""
    import copy
    import dataclasses

    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3

    cfg = dataclasses.replace(QWEN3_14B, layers=CONSISTENCY_LAYERS)
    model = Qwen3(cfg, gen=torch.Generator(device=dev).manual_seed(1), device=dev, dtype=torch.bfloat16)
    model32 = copy.deepcopy(model).float()
    rng = np.random.default_rng(8)
    b, t = 8, VERIFY_PROMPT_LEN
    lengths = np.array([t, 200, 131, 64, 40, 17, 3, 1])
    mask_np = (np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)
    ids_np = np.where(mask_np > 0, rng.integers(3, cfg.vocab_size, size=(b, t)), 0)
    ids, mask = torch.from_numpy(ids_np).to(dev), torch.from_numpy(mask_np).to(dev)
    valid = mask.bool()
    with torch.no_grad():
        a0 = attention_launches()
        hk, _ = model.prefill(ids, mask, t)
        lk = model.lm_logits(hk[:, -1:])[:, 0]
        launches = attention_launches() - a0
        with runtime.using(attention="xla"):
            hp, _ = model32.prefill(ids, mask, t)
            lp = model32.lm_logits(hp[:, -1:])[:, 0]
    require(launches == CONSISTENCY_LAYERS, f"4-layer prefill launched the attention kernel {launches} times")
    cos_h, cos_l = _cosines(hk[valid], hp[valid]), _cosines(lk, lp)
    out = {"layers": CONSISTENCY_LAYERS, "batch": b, "prompt_lengths": lengths.tolist(),
           "hidden_cosine_min": float(cos_h.min()), "hidden_cosine_mean": float(cos_h.mean()),
           "valid_rows": int(valid.sum()), "first_logits_cosine": [round(float(c), 6) for c in cos_l],
           "first_token_argmax_equal": int((lk.argmax(-1) == lp.argmax(-1)).sum())}
    require(bool(torch.isfinite(hk[valid]).all()) and bool(torch.isfinite(lk).all()), "non-finite Qwen3 outputs")
    require(float(cos_h.min()) >= COSINE_MIN and float(cos_l.min()) >= COSINE_MIN,
            f"Qwen3-14B 4-layer kernels-bf16 vs plain-f32 cosine {out} < {COSINE_MIN}")
    del model, model32
    torch.cuda.empty_cache()
    return out


def _host_breakdown(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler (CPU and CUDA): the ops it
    launched, their summed self CPU time, and the ops that took the most of
    it (self CPU ms and calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"aten_calls": sum(e.count for e in ops), "device_kernels": kernels,
            "aten_self_cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "top": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in ops[:top]]}


def _qwen3_serving(dev) -> dict:
    """QWEN3_14B at full depth in bf16: ``rl.verify.evaluate_merged`` on 128
    synthetic support tickets, batch 64, prompts left-padded to 256, 48 new
    tokens; then the same merged weights through the plain attention path on
    the first batch."""
    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3
    from multimodal_embedding_tpu_torch.rl import verify
    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.generate import generate
    from multimodal_embedding_tpu_torch.rl.lora import LoraConfig
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Qwen3(QWEN3_14B, gen=torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    adapters = _write_adapters(model, None, seed=2)
    dataset = generate_support_tickets(VERIFY_TICKETS, seed=43)  # verify_rl's default seed + 1

    calls: list[dict] = []
    calls_prefill: list[float] = []
    decode_launches = [0]
    prefill, decode_step = Qwen3.prefill, Qwen3.decode_step

    def timed_generate(m, ids, mask, max_new, **kw):
        torch.cuda.synchronize()
        a0, t0 = attention_launches(), time.perf_counter()
        toks, logps = generate(m, ids, mask, max_new, **kw)
        torch.cuda.synchronize()
        calls.append({"model": m, "ids": ids, "mask": mask, "toks": toks, "s": time.perf_counter() - t0,
                      "attention": attention_launches() - a0})
        return toks, logps

    def timed_prefill(m, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(m, *a, **kw)
        torch.cuda.synchronize()
        calls_prefill.append(time.perf_counter() - t0)
        return out

    def counted_decode_step(m, *a, **kw):
        a0 = attention_launches()
        out = decode_step(m, *a, **kw)
        decode_launches[0] += attention_launches() - a0
        return out

    verify.generate, Qwen3.prefill, Qwen3.decode_step = timed_generate, timed_prefill, counted_decode_step
    try:
        t0 = time.perf_counter()
        stats = verify.evaluate_merged(model, adapters, LoraConfig(), dataset, "category", max_new=VERIFY_NEW,
                                       batch_size=VERIFY_BATCH, max_prompt_len=VERIFY_PROMPT_LEN)
        eval_s = time.perf_counter() - t0
    finally:
        verify.generate, Qwen3.prefill, Qwen3.decode_step = generate, prefill, decode_step
    peak = torch.cuda.max_memory_allocated(dev)
    n_calls = VERIFY_TICKETS // VERIFY_BATCH
    require(len(calls) == n_calls == len(calls_prefill), f"{len(calls)} generate calls, want {n_calls}")
    per_call = [c["attention"] for c in calls]
    require(per_call == [QWEN3_14B.layers] * n_calls and decode_launches[0] == 0,
            f"attention launches per generate {per_call} (want {QWEN3_14B.layers} each), "
            f"{decode_launches[0]} during decode (want 0)")
    for k in ("no_think_rate", "clean_json_rate", "accuracy"):
        require(0.0 <= stats[k] <= 100.0, f"verify {k} = {stats[k]}")
    decode_s = [c["s"] - p for c, p in zip(calls, calls_prefill)]
    out = {"init_s": init_s, "evaluate_s": eval_s, "stats": stats, "attention_launches_per_generate": per_call,
           "prefill_ms": [1e3 * p for p in calls_prefill], "generate_s": [c["s"] for c in calls],
           "decode_step_ms": [1e3 * d / VERIFY_NEW for d in decode_s],
           "decode_tokens_per_s": [VERIFY_BATCH * VERIFY_NEW / d for d in decode_s], "peak_memory_bytes": peak}

    # one decode step alone, on the merged weights: events around the call
    # (host time included) against the device time of its kernels
    merged, ids, mask, toks = (calls[0][k] for k in ("model", "ids", "mask", "toks"))
    cfg = merged.cfg
    tp = ids.shape[1]
    with torch.no_grad():
        hidden, kv = merged.prefill(ids, mask, tp + VERIFY_NEW)
        first_k = merged.lm_logits(hidden[:, -1:])[:, 0]
        del hidden
        cache_valid = torch.cat([mask > 0, torch.zeros(ids.shape[0], VERIFY_NEW, dtype=torch.bool, device=dev)], 1)
        cache_valid[:, tp] = True
        args = (kv, toks[:, 0], mask.sum(-1), tp, cache_valid)
        step_ms = cuda_time_ms(lambda: merged.decode_step(*args))
        step_dev_ms = device_ms(lambda: merged.decode_step(*args))
        host = _host_breakdown(lambda: merged.decode_step(*args))
    # its bound: every layer weight, the head and the whole cache read once;
    # the products' operations (2 a weight a row, QK^T and PV over the cache)
    weights = sum(p.numel() for p in merged.layers.parameters()) + merged.lm_head.numel()
    cache_bytes = 2 * kv["k"].numel() * kv["k"].element_size()
    flops = 2.0 * weights * VERIFY_BATCH + 4.0 * VERIFY_BATCH * cfg.heads * (tp + VERIFY_NEW) * cfg.head_dim * cfg.layers
    step_bound, step_by = bound_ms(flops, 2 * weights + cache_bytes, "bf16_flops")
    del kv, args
    out.update(decode_step_alone_ms=step_ms, decode_step_device_ms=step_dev_ms, decode_step_bound_ms=step_bound,
               decode_step_bound_by=step_by, weight_bytes=2 * weights, cache_bytes=cache_bytes,
               decode_step_host=host)

    # the same merged weights through the plain attention path, first batch
    with runtime.using(attention="xla"):
        a0 = attention_launches()
        plain_toks, _ = generate(merged, ids, mask, VERIFY_NEW, greedy=True)
        with torch.no_grad():
            hidden, _ = merged.prefill(ids, mask, tp)
            first_p = merged.lm_logits(hidden[:, -1:])[:, 0]
        require(attention_launches() == a0, "the plain path launched the attention kernel")
    cos = _cosines(first_k, first_p)
    out.update(plain_token_agreement=float((plain_toks == toks).float().mean()),
               plain_first_token_equal=float((plain_toks[:, 0] == toks[:, 0]).float().mean()),
               plain_first_logits_cosine_min=float(cos.min()))
    require(float(cos.min()) >= QWEN3_LOGIT_COSINE_MIN,
            f"Qwen3-14B first-token logits, kernel vs plain attention: cosine {float(cos.min())} "
            f"< {QWEN3_LOGIT_COSINE_MIN}")
    del model, merged, calls, adapters, hidden
    torch.cuda.empty_cache()
    return out


def _verify_cli(arch: str, adapters_path: Path, base_params: Path | None = None) -> tuple[dict, dict]:
    """``cli/verify_rl.py`` in-process, on a random init at ``--model-size
    small`` or on ``base_params``: (its stats line, the launch counts)."""
    import ast
    import contextlib
    import io

    from multimodal_embedding_tpu_torch.cli import verify_rl
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify_rl.main(["--arch", arch, *VERIFY_CLI_ARGS, "--adapters", str(adapters_path),
                             *(["--base-params", str(base_params)] if base_params else [])])
    counts = launch_counts()
    text = buf.getvalue()
    require(rc == 0, f"verify_rl --arch {arch} exited {rc}: {text[-2000:]}")
    stats = ast.literal_eval(text.strip().splitlines()[-1])
    for k in ("no_think_rate", "clean_json_rate", "accuracy"):
        require(0.0 <= stats[k] <= 100.0, f"verify_rl --arch {arch} {k} = {stats[k]}")
    require(stats["n"] == 16 and counts["fused_attention_f32"] > 0, f"verify_rl --arch {arch}: {stats}, {counts}")
    return stats, counts


def phase_workload_b(kernels: list[dict]) -> None:
    """Phase 8 (see the module docstring)."""
    import torch

    from multimodal_embedding_tpu_torch.cli.train_rl import default_gemma_config, default_qwen3_config
    from multimodal_embedding_tpu_torch.rl.policy import get_arch

    dev = torch.device("cuda")
    card = card_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cons = _qwen3_consistency(dev)
    print(f"[phase8] Qwen3-14B full width, {CONSISTENCY_LAYERS} layers, kernels bf16 vs plain f32: "
          f"{json.dumps(cons)}")
    serving = _qwen3_serving(dev)
    print(f"[phase8] Qwen3-14B 40 layers bf16, rl.verify.evaluate_merged ({VERIFY_TICKETS} tickets, batch "
          f"{VERIFY_BATCH}, prompts {VERIFY_PROMPT_LEN}, {VERIFY_NEW} new tokens): {json.dumps(serving)}; "
          f"card {card}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for arch, cfg in (("qwen3", default_qwen3_config("small")), ("gemma", default_gemma_config("small"))):
        path = OUT_DIR / f"{arch}_small_adapters.npz"
        _write_adapters(get_arch(arch).init(cfg, seed=0, device=dev), path, seed=3)
        torch.cuda.empty_cache()
        stats, counts = _verify_cli(arch, path)
        paths[arch] = counts
        print(f"[phase8] verify_rl --arch {arch} {' '.join(VERIFY_CLI_ARGS)}: {stats}; launches {json.dumps(counts)}")
    cli_counts = {n: paths["qwen3"][n] + paths["gemma"][n] for n in paths["qwen3"]}
    for k in kernels:
        k["launches_by_path"]["qwen3-14b verify"] = (
            sum(serving["attention_launches_per_generate"]) if k["name"] == "fused_attention" else 0)
        k["launches_by_path"]["verify_rl CLI"] = cli_counts.get(k["name"], 0)
    print(f"[phase8] {time.perf_counter() - t_phase:.1f} s")


# --- phase 9: Workload B training -----------------------------------------------------

# the reference's GRPO setup (lr 1e-5, KL beta 0.04, LoRA rank 16 alpha 32 on
# q/k/v/o: GRPOConfig's defaults), a group of 8 and 48 new tokens; 4 support
# tickets at grad-accum 2 make 2 optimizer steps
GRPO_PROMPTS, GRPO_ACCUM = 4, 2
# Qwen3-14B at full width cut to 4 layers, kernels in bf16 against the plain
# attention path on the f32 weights: each adapter gradient's cosine, and the
# relative difference of loss, pg and kl
GRPO_GRAD_COSINE_MIN = 0.99
GRPO_LOSS_REL_TOL = 5e-2
TRAIN_CLI_ARGS = ["--model-size", "small", "--format-pretrain", "20", "--dataset-size", "8", "--epochs", "1",
                  "--grad-accum", "2"]


def _random_b(trainer, seed: int) -> None:
    """Draw every adapter's ``b`` at std 0.02 in place (the optimizer keeps
    the same tensors). ``lora_init``'s ``b`` = 0 makes the policy the base, and
    a random-weight policy's rewards are flat, so the gradient would be exactly
    zero: with ``b`` drawn, the KL term carries a gradient."""
    import torch

    gen = torch.Generator(device=trainer.base.device).manual_seed(seed)
    with torch.no_grad():
        for ab in trainer.adapters.values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=trainer.base.device) * 0.02)


def _grpo_consistency(dev) -> dict:
    """QWEN3_14B at full width cut to 4 layers: one ``loss_and_grads`` on a
    rollout of one support ticket (a group of 8, 48 tokens) with advantages
    +-1, through the kernels in bf16 against the plain attention path on the
    f32 weights, the same adapters (``b`` drawn) and each side's own
    ``ref_logps``."""
    import copy
    import dataclasses

    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3
    from multimodal_embedding_tpu_torch.rl import grpo
    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.rewards import support_ticket_reward

    cfg = dataclasses.replace(QWEN3_14B, layers=CONSISTENCY_LAYERS)
    model = Qwen3(cfg, gen=torch.Generator(device=dev).manual_seed(4), device=dev, dtype=torch.bfloat16)
    model32 = copy.deepcopy(model).float()
    trainers = {side: grpo.GRPOTrainer(m, support_ticket_reward, grpo.GRPOConfig())
                for side, m in (("kernels_bf16", model), ("plain_f32", model32))}
    trainer = trainers["kernels_bf16"]
    _random_b(trainer, seed=5)
    prompt = generate_support_tickets(1, seed=44)[0]["prompt"]
    p_ids, p_mask, comps = (torch.from_numpy(x).to(dev) for x in trainer.rollout(prompt)[:3])
    comp_mask = grpo.completion_token_mask(comps)
    adv = torch.tensor([1.0, -1.0] * 4, device=dev)
    out = {"layers": CONSISTENCY_LAYERS, "batch": int(p_ids.shape[0]), "prompt_tokens": int(p_ids.shape[1]),
           "completion_tokens": int(comp_mask.sum())}
    runs = {}
    for side, tr in trainers.items():
        with runtime.using(attention="auto" if side == "kernels_bf16" else "xla"):
            a0 = attention_launches()
            with torch.no_grad():
                ref = grpo._completion_logps(tr.base, p_ids, p_mask, comps)
            (loss, (pg, kl)), grads = tr.loss_and_grads(trainer.adapters, p_ids, p_mask, comps, comp_mask, adv, ref)
            runs[side] = (float(loss), float(pg), float(kl), grads, attention_launches() - a0)
    (lk, pk, kk, gk, nk), (lp, pp, kp, gp, np_) = runs["kernels_bf16"], runs["plain_f32"]
    require(nk == 2 * CONSISTENCY_LAYERS and np_ == 0,
            f"attention launches: kernels {nk} (want {2 * CONSISTENCY_LAYERS}: ref and loss passes), plain {np_}")
    rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, a, b in (("loss", lk, lp), ("pg", pk, pp), ("kl", kk, kp))}
    cos = {f"{n}.{p}": float(torch.nn.functional.cosine_similarity(
        gk[n][p].double().flatten(), gp[n][p].double().flatten(), dim=0)) for n in gk for p in ("a", "b")}
    out.update(loss=[lk, lp], pg=[pk, pp], kl=[kk, kp], rel_diff=rel, grad_cosine=cos,
               grad_cosine_min=min(cos.values()))
    require(all(math.isfinite(x) for x in (lk, pk, kk)) and kk > 0, f"GRPO loss terms {out}")
    require(min(cos.values()) >= GRPO_GRAD_COSINE_MIN,
            f"Qwen3-14B 4-layer GRPO gradient cosine {cos} < {GRPO_GRAD_COSINE_MIN}")
    require(max(rel.values()) <= GRPO_LOSS_REL_TOL, f"Qwen3-14B 4-layer GRPO loss terms {rel} > {GRPO_LOSS_REL_TOL}")
    del model, model32, trainers, trainer
    torch.cuda.empty_cache()
    return out


def _timed_train(trainer, tickets: list[dict]) -> dict:
    """``trainer.train(tickets)`` with each prompt's parts timed (rollout,
    reference pass, loss forward + backward, optimizer) and the attention
    launches of each part counted apart."""
    import torch

    from multimodal_embedding_tpu_torch.rl import grpo

    parts: list[dict] = []
    completion_logps = grpo._completion_logps

    def timed(part, fn):
        def run(*a, **kw):
            if part == "rollout":
                parts.append({})
            torch.cuda.synchronize()
            a0, t0 = attention_launches(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[-1][f"{part}_s"] = time.perf_counter() - t0
            parts[-1][f"{part}_attention"] = attention_launches() - a0
            return out
        return run

    ref_pass = timed("ref", completion_logps)

    def logps(*a, **kw):  # the ref pass runs without grad; the loss pass's forward is timed with its backward
        return completion_logps(*a, **kw) if torch.is_grad_enabled() else ref_pass(*a, **kw)

    wrapped = {"rollout": "rollout", "loss_and_grads": "loss_fwd_bwd", "_update": "optimizer"}
    for attr, part in wrapped.items():
        setattr(trainer, attr, timed(part, getattr(trainer, attr)))
    grpo._completion_logps = logps
    try:
        a0 = attention_launches()
        t0 = time.perf_counter()
        stats = trainer.train(tickets)
        train_s = time.perf_counter() - t0
        launches = attention_launches() - a0
    finally:
        grpo._completion_logps = completion_logps
        for attr in wrapped:  # the wrappers hold the trainer: a cycle that would keep its model on the card
            delattr(trainer, attr)
    return {"train_s": train_s, "per_prompt": parts, "stats": stats, "attention_launches": launches}


def _grpo_training(dev) -> dict:
    """QWEN3_14B at full depth in bf16: ``GRPOTrainer.train`` on
    ``GRPO_PROMPTS`` support tickets at ``grad_accum`` ``GRPO_ACCUM``, each
    step's parts timed and its attention launches counted apart."""
    import torch

    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3
    from multimodal_embedding_tpu_torch.rl import grpo
    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.rewards import support_ticket_reward

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = Qwen3(QWEN3_14B, gen=torch.Generator(device=dev).manual_seed(6), device=dev, dtype=torch.bfloat16)
    cfg = grpo.GRPOConfig(group_size=8, epochs=1, grad_accum=GRPO_ACCUM, max_new_tokens=48)
    trainer = grpo.GRPOTrainer(model, support_ticket_reward, cfg)
    _random_b(trainer, seed=7)
    before = {n: {p: x.detach().clone() for p, x in ab.items()} for n, ab in trainer.adapters.items()}
    run = _timed_train(trainer, generate_support_tickets(GRPO_PROMPTS, seed=45))
    stats, parts, launches = run["stats"], run["per_prompt"], run["attention_launches"]
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    moved = {f"{n}.{p}": float((x.detach() - before[n][p]).abs().max()) for n, ab in trainer.adapters.items()
             for p, x in ab.items()}
    steps = int(trainer.opt.state[trainer._params[0]]["step"])
    L = QWEN3_14B.layers
    out = {"train_s": run["train_s"], "prompts": GRPO_PROMPTS, "optimizer_steps": steps, "per_prompt": parts,
           "stats": stats, "adapter_max_move": moved, "attention_launches": launches,
           "peak_memory_bytes": peak, "device_memory_bytes": total}
    require(steps == GRPO_PROMPTS // GRPO_ACCUM and len(parts) == GRPO_PROMPTS
            and sum("optimizer_s" in p for p in parts) == steps, f"GRPO steps {steps}, parts {parts}")
    require(all(v > 0 for v in moved.values()), f"adapters did not move: {moved}")
    require(np.isfinite(stats["loss"]).all() and np.isfinite(stats["kl"]).all(), f"GRPO stats {stats}")
    require(all(p["rollout_attention"] == p["ref_attention"] == p["loss_fwd_bwd_attention"] == L for p in parts)
            and launches == 3 * L * GRPO_PROMPTS,
            f"attention launches per prompt {parts} (want {L} in each of rollout prefill, ref and loss passes)")
    require(peak < total, f"peak device memory {peak} of {total}")
    del model, trainer, before
    torch.cuda.empty_cache()
    return out


def _train_then_verify_cli(arch: str) -> dict:
    """``cli/train_rl.py`` in-process, then ``cli/verify_rl.py`` on the base
    and adapters it saved: the training stats, the verify stats line and each
    CLI's launch counts."""
    from multimodal_embedding_tpu_torch.cli import train_rl
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    out_dir = OUT_DIR / f"train_rl_{arch}"
    base = out_dir / "base.npz"
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_rl.main(["--arch", arch, *TRAIN_CLI_ARGS, "--save-base", str(base), "--output-dir", str(out_dir)])
    train_s = time.perf_counter() - t0
    counts = {"train_rl": launch_counts()}
    require(rc == 0 and counts["train_rl"]["fused_attention_f32"] > 0, f"train_rl --arch {arch}: rc {rc}, {counts}")
    with np.load(out_dir / "training_stats.npz") as data:
        stats = {k: data[k].tolist() for k in data.files}
    require(sorted(stats) == ["adv_std", "kl", "loss", "mean_reward", "parse_rate"]
            and all(len(v) == 8 and np.isfinite(v).all() for v in stats.values()), f"training stats {stats}")
    verify, counts["verify_rl"] = _verify_cli(arch, out_dir / "lora_adapters.npz", base)
    return {"train_s": train_s, "stats": stats, "verify": verify, "launches": counts}


def phase_workload_b_training(kernels: list[dict]) -> None:
    """Phase 9 (see the module docstring)."""
    import torch

    dev = torch.device("cuda")
    card = card_line()
    t_phase = time.perf_counter()
    cons = _grpo_consistency(dev)
    print(f"[phase9] Qwen3-14B full width, {CONSISTENCY_LAYERS} layers, one GRPO loss_and_grads, kernels bf16 vs "
          f"plain f32: {json.dumps(cons)}")
    training = _grpo_training(dev)
    print(f"[phase9] Qwen3-14B 40 layers bf16, GRPOTrainer.train ({GRPO_PROMPTS} tickets, group 8, 48 new tokens, "
          f"grad-accum {GRPO_ACCUM}): {json.dumps(training)}; card {card}")
    clis = {}
    for arch in ("qwen3", "gemma"):
        clis[arch] = _train_then_verify_cli(arch)
        torch.cuda.empty_cache()
        print(f"[phase9] train_rl --arch {arch} {' '.join(TRAIN_CLI_ARGS)}, then verify_rl: {json.dumps(clis[arch])}")
    for k in kernels:
        attention = k["name"] == "fused_attention"
        k["launches_by_path"]["qwen3-14b grpo"] = training["attention_launches"] if attention else 0
        k["launches_by_path"]["train_rl CLI"] = sum(c["launches"]["train_rl"].get(k["name"], 0)
                                                    for c in clis.values())
    print(f"[phase9] {time.perf_counter() - t_phase:.1f} s")


# --- phase 10: two ranks on the one card ----------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "OpenAI-CLIP-L", "--sample-size", "128",
    "--batch-size", "32", "--bootstrap-iterations", "100", "--device", "cuda:0",
]
TP_COSINE_MIN = 0.999  # bf16 partial products summed over 2 ranks, against one rank's kernels
DP_COSINE_MIN = 0.9999  # the same kernels on half the rows of each batch
PARALLEL_TIMEOUT_S = 420


class _Recorder:
    """Wraps the engine's encode methods and the attention wrapper while a
    rank drives a path: the last image and text embeddings (by caption
    count), the engine's image and text batch calls, and the q shapes the
    attention kernel saw."""

    def __init__(self):
        from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
        from multimodal_embedding_tpu_torch.ops import attention_cuda

        self.images = None
        self.texts: dict[int, object] = {}
        self.calls = {"image": 0, "text": 0}
        self.q_shapes: set = set()
        self._saved = []
        rec = self

        def wrap(owner, name, after):
            real = getattr(owner, name)

            def f(*a, **kw):
                out = real(*a, **kw)
                after(a, out)
                return out

            self._saved.append((owner, name, real))
            setattr(owner, name, f)

        wrap(EncodingEngine, "encode_images_cached", lambda a, out: setattr(rec, "images", out.embeddings))
        wrap(EncodingEngine, "encode_texts", lambda a, out: rec.texts.__setitem__(len(a[1]), out))
        wrap(EncodingEngine, "_image_batch", lambda a, out: rec.calls.__setitem__("image", rec.calls["image"] + 1))
        wrap(EncodingEngine, "_text_batch", lambda a, out: rec.calls.__setitem__("text", rec.calls["text"] + 1))
        wrap(attention_cuda, "fused_attention", lambda a, out: rec.q_shapes.add(tuple(a[0].shape)))

    def close(self):
        for owner, name, real in self._saved:
            setattr(owner, name, real)


def _rank_reference(records, dev):
    """OpenAI-CLIP-L (the CLI's seed) on this rank alone, through the
    kernels: the images and both caption sweeps."""
    import torch

    from multimodal_embedding_tpu_torch.cli.main import SEED, load_model_for
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
    from multimodal_embedding_tpu_torch.models.registry import model_info

    model = load_model_for(model_info("OpenAI-CLIP-L"), debug=False, arch=True, seed=SEED, device=dev)
    engine = EncodingEngine(model, 32, device=dev)
    ref = {"images": engine.encode_images([r["image"] for r in records]).embeddings,
           "t2i": engine.encode_texts([r["captions"][0] for r in records]).embeddings,
           "all": engine.encode_texts([c for r in records for c in r["captions"][:5]]).embeddings}
    del model, engine
    torch.cuda.empty_cache()
    return ref


def _rank_cli(tag: str, flags: list[str], out: Path, ref: dict, report: dict) -> dict:
    """One CLI run on every rank, its launches counted from 0 around it;
    returns the recorder's cosines against one rank's embeddings."""
    import torch

    from multimodal_embedding_tpu_torch.cli import main as cli
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    rec = _Recorder()
    boot_checks = []
    real_boot = cli.bootstrap_benchmark

    def boot(s_t2i, s_i2t, n, **kw):  # the same scores on one rank: bit-equal metrics
        got = real_boot(s_t2i, s_i2t, n, **kw)
        alone = real_boot(s_t2i, s_i2t, n, **{**kw, "mesh": None})
        boot_checks.append(kw.get("mesh") is not None and all(
            np.array_equal(got.metrics[k], alone.metrics[k]) for k in alone.metrics)
            and np.array_equal(got.sample_idx, alone.sample_idx) and np.array_equal(got.correct_r1, alone.correct_r1))
        return got

    cli.bootstrap_benchmark = boot
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main([*PARALLEL_CLI_ARGS, *flags, "--output", str(out / f"{tag}.csv")])
    finally:
        counts = launch_counts()
        cli.bootstrap_benchmark = real_boot
        rec.close()
    require(rc == 0, f"{tag}: CLI exited {rc}")
    cos = {"images": _cosines(rec.images, ref["images"]), "t2i": _cosines(rec.texts[128].embeddings, ref["t2i"]),
           "all": _cosines(rec.texts[640].embeddings, ref["all"])}
    report[tag] = {"seconds": time.perf_counter() - t0, "counts": counts, "calls": rec.calls,
                   "q_shapes": sorted(rec.q_shapes), "peak_bytes": torch.cuda.max_memory_allocated(),
                   "cosine_min": {k: float(v.min()) for k, v in cos.items()},
                   "bootstrap_bit_equal": boot_checks}
    return report[tag]


def _rank_colpali_sp(dev, report: dict) -> None:
    """ColPali-v1.3 at full width under --sequence-parallel 2 through the
    engine, 8 images and 16 queries, against the same engine on one rank."""
    import torch

    from multimodal_embedding_tpu_torch.cli.main import SEED, load_model_for
    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.data.coco import load_benchmark_dataset
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts
    from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh
    from multimodal_embedding_tpu_torch.retrieval.scoring import late_interaction_scores

    records = load_benchmark_dataset("synthetic", sample_size=16, seed=SEED)
    images, queries = [r["image"] for r in records[:8]], [r["captions"][0] for r in records]
    model = load_model_for(model_info("ColPali-v1.3"), debug=False, arch=True, seed=SEED, device=dev)
    mesh = get_mesh(n_model=PARALLEL_RANKS)
    engine = EncodingEngine(model, 4, device=dev, mesh=mesh)
    alone_img, alone_txt = engine.encode_images(images).embeddings, engine.encode_texts(queries)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with runtime.using(sp=mesh):
        img, txt = engine.encode_images(images).embeddings, engine.encode_texts(queries)
        scores = late_interaction_scores(txt.embeddings, img, impl="auto", mesh=mesh)
    torch.cuda.synchronize()
    counts = launch_counts()
    valid = txt.mask.bool()
    cos = torch.cat([_cosines(img.flatten(0, 1), alone_img.flatten(0, 1)),
                     _cosines(txt.embeddings[valid], alone_txt.embeddings[valid])])
    report["sp2 colpali"] = {
        "seconds": time.perf_counter() - t0, "counts": counts, "peak_bytes": torch.cuda.max_memory_allocated(),
        "shapes": [list(img.shape), list(txt.embeddings.shape)], "tokens": int(cos.numel()),
        "cosine_min": float(cos.min()), "cosine_mean": float(cos.mean()),
        "pads_zero": bool((txt.embeddings[~valid] == 0).all()), "pads": int((~valid).sum()),
        "scores_finite": bool(scores.isfinite().all()), "scores_shape": list(scores.shape),
    }
    del model, engine
    torch.cuda.empty_cache()


def parallel_rank(out: Path) -> int:
    """One rank of phase 10, started by torchrun: --tensor-parallel 2 and
    plain data parallelism through the CLI on OpenAI-CLIP-L, then
    --sequence-parallel 2 on ColPali-v1.3 through the engine; its report goes
    to ``out/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from multimodal_embedding_tpu_torch.cli.main import SEED
    from multimodal_embedding_tpu_torch.data.coco import load_benchmark_dataset
    from multimodal_embedding_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed("cuda:0", timeout_s=180)  # gloo: both ranks share the card
    rank = dist.get_rank()
    report = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    records = load_benchmark_dataset("synthetic", sample_size=128, seed=SEED)
    t0 = time.perf_counter()
    ref = _rank_reference(records, dev)
    report["reference_seconds"] = time.perf_counter() - t0
    _rank_cli("tp2 clip-l", ["--tensor-parallel", str(PARALLEL_RANKS)], out, ref, report)
    _rank_cli("dp2 clip-l", [], out, ref, report)
    del ref
    torch.cuda.empty_cache()
    _rank_colpali_sp(dev, report)
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel(kernels: list[dict]) -> None:
    """Phase 10: two ranks on the one H100 through gloo (``--device
    cuda:0``), launched by torchrun; the kernels were built by phase 1."""
    import os
    import shutil
    import signal

    import pandas as pd

    out = OUT_DIR / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(PARALLEL_RANKS),
           str(ROOT / "chip_smoke.py"), "--parallel-rank", str(out)]
    proc = subprocess.Popen(cmd, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=PARALLEL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and both ranks
        log, _ = proc.communicate()
    (out / "torchrun.log").write_text(log)
    if proc.returncode != 0:
        print(log[-6000:])
    require(proc.returncode == 0, f"phase 10: torchrun exited {proc.returncode}")
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(PARALLEL_RANKS)]
    for rep in reports:
        require(rep["backend"] == "gloo" and rep["device"] == "cuda:0", f"rank layout {rep}")
        tp, dp, sp = rep["tp2 clip-l"], rep["dp2 clip-l"], rep["sp2 colpali"]
        # a) TP: each rank's 8 of 16 vision heads, 6 of 12 text heads
        want_attn = 24 * tp["calls"]["image"] + 12 * tp["calls"]["text"]
        require(tp["counts"]["fused_attention"] == want_attn and tp["counts"]["preprocess"] > 0
                and tp["counts"]["mlp_activation"] == want_attn,
                f"rank {rep['rank']} tp launches {tp['counts']}, want {want_attn} attention and MLP activations")
        require([tuple(s) for s in tp["q_shapes"]] == [(32, 577, 512), (128, 77, 384)],
                f"rank {rep['rank']} tp attention shapes {tp['q_shapes']}")
        require(min(tp["cosine_min"].values()) >= TP_COSINE_MIN, f"tp cosine {tp['cosine_min']}")
        # b) DP: half of each batch a rank, the bootstrap bit-equal to one rank's
        require(min(dp["cosine_min"].values()) >= DP_COSINE_MIN, f"dp cosine {dp['cosine_min']}")
        require(dp["bootstrap_bit_equal"] == [True], f"dp bootstrap not bit-equal to one rank")
        require(dp["counts"]["fused_attention"] == 24 * dp["calls"]["image"] + 12 * dp["calls"]["text"],
                f"dp launches {dp['counts']}")
        # c) SP on ColPali
        require(sp["cosine_min"] >= COLPALI_COSINE_MIN and sp["cosine_mean"] >= COSINE_MIN,
                f"sp per-token cosine min {sp['cosine_min']}, mean {sp['cosine_mean']}")
        require(sp["pads_zero"] and sp["scores_finite"], f"sp pads or scores: {sp}")
        require(all(sp["counts"][k] > 0 for k in ("fused_attention", "preprocess", "maxsim")),
                f"sp launches {sp['counts']}")
    for tag in ("tp2 clip-l", "dp2 clip-l"):
        df = pd.read_csv(out / f"{tag}.csv")
        require(list(df["Model"]) == ["OpenAI-CLIP-L"], f"{tag} CSV rows {list(df['Model'])}")
        for col in REFERENCE_COLUMNS[2:-5]:
            val = float(df[col].iloc[0])
            require(math.isfinite(val) and 0.0 <= val <= 100.0, f"{tag} {col} = {val}")
        for rep in reports:
            rep[tag]["qps"] = float(df["QPS"].iloc[0])
    for rep in reports:
        print(f"[parallel] rank {rep['rank']}: " + json.dumps({k: v for k, v in rep.items() if k != "rank"}))
    print(f"[parallel] two processes time-slicing one card, collectives through host memory (gloo): the QPS is "
          f"not a scaling figure; tp2 QPS {reports[0]['tp2 clip-l']['qps']}, dp2 QPS "
          f"{reports[0]['dp2 clip-l']['qps']}")
    for k in kernels:
        for tag in ("tp2 clip-l", "dp2 clip-l", "sp2 colpali"):
            k["launches_by_path"][tag] = reports[0][tag]["counts"].get(k["name"], 0)
    print(f"[phase10] {time.perf_counter() - t0:.1f} s")


# --- phase 11: Workload B on a (data, model) mesh, two ranks on the one card ---------

TP_GRPO_RANKS = 2
TP_GRPO_TIMEOUT_S = 600
# rank 0's launches in dryrun_multichip(2): its debug models run in f32, so
# every attention and MaxSim launch is the f32 body's
DRYRUN_LAUNCHES = {"fused_attention": 0, "fused_attention_f32": 28, "preprocess": 4, "maxsim": 0, "maxsim_f32": 2}
# tensor parallelism 2 against one rank, the 4-layer cut in bf16: each
# adapter gradient's cosine, loss, pg and kl, and the greedy rollout's tokens
# position by position, each fed one rank's tokens before it (bf16 sums in
# another order move near-ties; free-running, one flip changes the rest of
# its row, which is reported beside it)
TP_GRAD_COSINE_MIN = 0.999
TP_LOSS_REL_TOL = 2e-2
TP_GREEDY_EQUAL_MIN = 0.9
# data parallelism 2 against one rank on the f32 weights: the same kernels on
# half the group a rank
DP_GRAD_COSINE_MIN = 0.99999
DP_LOSS_REL_TOL = 1e-4
TP_SHAPES = [(8, 224, 20 * 128), (8, 272, 20 * 128)]  # one rank's q: the rollout prefill, the GRPO passes


@contextlib.contextmanager
def _q_shapes():
    """The q shapes the attention wrapper sees in the body of a ``with``."""
    from multimodal_embedding_tpu_torch.ops import attention_cuda

    shapes: set = set()
    real = attention_cuda.fused_attention

    def recording(q, *a, **kw):
        shapes.add(tuple(q.shape))
        return real(q, *a, **kw)

    attention_cuda.fused_attention = recording
    try:
        yield shapes
    finally:
        attention_cuda.fused_attention = real


def _adapter_crcs(adapters) -> dict:
    """crc32 of each adapter's bytes: equal across ranks iff bit-equal."""
    return {f"{n}.{p}": zlib.crc32(x.detach().cpu().numpy().tobytes()) for n, ab in adapters.items()
            for p, x in ab.items()}


def _qwen3_tp_shard(cfg, mesh, seed: int, dev):
    """This rank's shard of an arch-random Qwen3 in bf16, drawn on the card
    layer by layer from one generator (the draws of ``Qwen3(cfg, gen=...)``),
    each layer split as it is made: the card holds this rank's slices and
    one whole layer at most, never the whole model."""
    import dataclasses

    import torch
    from torch import nn

    from multimodal_embedding_tpu_torch.models.qwen3 import Qwen3, Qwen3Layer
    from multimodal_embedding_tpu_torch.parallel.tp import shard_params_tp

    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [shard_params_tp(Qwen3Layer(cfg, gen=gen, device=dev, dtype=torch.bfloat16), mesh)
              for _ in range(cfg.layers)]
    model = Qwen3(dataclasses.replace(cfg, layers=0), gen=gen, device=dev, dtype=torch.bfloat16)
    model.cfg, model.layers = cfg, nn.ModuleList(layers)
    return model


def _rank_tp_training(dev, report: dict) -> None:
    """Part 1: one GRPO step of Qwen3-14B at full width and depth, split
    over the two ranks (one ticket, a group of 8, 48 sampled tokens)."""
    import torch

    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B
    from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh
    from multimodal_embedding_tpu_torch.rl import grpo
    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.rewards import support_ticket_reward

    mesh = get_mesh(1, TP_GRPO_RANKS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = _qwen3_tp_shard(QWEN3_14B, mesh, seed=6, dev=dev)
    torch.cuda.synchronize()
    build_s, weight_bytes = time.perf_counter() - t0, torch.cuda.memory_allocated(dev)
    cfg = grpo.GRPOConfig(group_size=8, epochs=1, grad_accum=1, max_new_tokens=48)
    trainer = grpo.GRPOTrainer(model, support_ticket_reward, cfg, mesh=mesh)
    _random_b(trainer, seed=7)
    with _q_shapes() as shapes:
        run = _timed_train(trainer, generate_support_tickets(1, seed=45))
    report["tp2 qwen3-14b"] = {
        **run, "build_s": build_s, "weight_bytes": weight_bytes, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "q_shapes": sorted(shapes), "optimizer_steps": int(trainer.opt.state[trainer._params[0]]["step"]),
        "adapter_crc": _adapter_crcs(trainer.adapters)}
    del model, trainer
    torch.cuda.empty_cache()


def _greedy_agreement(one, tp, dev) -> dict:
    """Greedy rollouts (48 tokens) of 8 support tickets, each row its own
    ticket, from the split policy against one rank's on the same adapters.
    ``greedy_equal``: the share of equal tokens, where one flipped near-tie
    changes the rest of its row. ``teacher_forced_argmax_equal``: the share
    of positions where the split policy's argmax, fed one rank's tokens, is
    one rank's token: each position once, no cascade (the gate). Beside it,
    ``one_rank_self_equal``: one rank's own full forward against its own
    decode steps, the floor of such flips with no split at all."""
    import torch

    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.generate import generate

    tk, max_len = one.tokenizer, one.cfg.max_prompt_len
    ids = [tk.encode(tk.format_prompt(t["prompt"], None), max_len) for t in generate_support_tickets(8, seed=46)]
    p_ids, p_mask = (torch.from_numpy(x).to(dev) for x in tk.pad_left(ids, max_len=-(-max(map(len, ids)) // 32) * 32))
    policies = {"one": one.policy(), "tp2": tp.policy()}
    tokens = {tag: generate(m, p_ids, p_mask, 48, greedy=True)[0] for tag, m in policies.items()}
    same = (tokens["tp2"] == tokens["one"]).float()
    full = torch.cat([p_ids, tokens["one"].to(p_ids.dtype)], dim=1)
    mask = torch.cat([p_mask, torch.ones_like(tokens["one"], dtype=p_mask.dtype)], dim=1)
    t = p_ids.shape[1]
    with torch.no_grad():
        argmax = {tag: m.lm_logits(m(m.embed_tokens(full), mask, True)[:, t - 1 : -1]).argmax(-1)
                  for tag, m in policies.items()}
    return {"greedy_equal": float(same.mean()), "greedy_equal_by_row": same.mean(1).tolist(),
            "prompt_tokens": t, "teacher_forced_argmax_equal": float((argmax["tp2"] == argmax["one"]).float().mean()),
            "one_rank_self_equal": float((argmax["one"] == tokens["one"]).float().mean())}


def _rank_cut_checks(dev, report: dict) -> None:
    """Parts 2 and 3: Qwen3-14B at full width cut to 4 layers, one
    ``loss_and_grads`` on the same weights, adapters (``b`` drawn),
    completions and ``ref_logps`` split over the two ranks (TP 2, bf16) and
    on half the group a rank (DP 2, on the f32 weights, and in bf16 for the
    record), each against the same model in the same dtype on this rank
    alone, then each side's AdamW step; before them, the greedy rollout of
    the split policy against one rank's. (In bf16 each DP rank's weight
    gradient, a sum over its half of the tokens, is rounded to bf16 before
    the two are summed, where one rank rounds the whole sum once.)"""
    import copy
    import dataclasses

    import torch

    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3
    from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh, share_from_rank0
    from multimodal_embedding_tpu_torch.parallel.tp import shard_params_tp
    from multimodal_embedding_tpu_torch.rl import grpo
    from multimodal_embedding_tpu_torch.rl.datasets import generate_support_tickets
    from multimodal_embedding_tpu_torch.rl.rewards import support_ticket_reward

    t0 = time.perf_counter()
    cfg = dataclasses.replace(QWEN3_14B, layers=CONSISTENCY_LAYERS)
    whole = Qwen3(cfg, gen=torch.Generator(device=dev).manual_seed(8), device=dev, dtype=torch.bfloat16)
    whole32 = copy.deepcopy(whole).float()
    tp_mesh, dp_mesh = get_mesh(1, TP_GRPO_RANKS), get_mesh(TP_GRPO_RANKS, 1)

    def trainer(model, mesh=None):
        return grpo.GRPOTrainer(model, support_ticket_reward, grpo.GRPOConfig(), mesh=mesh)

    one, one32 = trainer(whole), trainer(whole32)
    _random_b(one, seed=9)
    # (trainer, the one-rank trainer it is held to)
    sides = {"tp2": (trainer(shard_params_tp(copy.deepcopy(whole), tp_mesh), tp_mesh), one),
             "dp2": (trainer(whole32, dp_mesh), one32), "dp2 bf16": (trainer(whole, dp_mesh), one)}
    with torch.no_grad():
        for tr in (one32, *(t for t, _ in sides.values())):
            for n, ab in tr.adapters.items():
                for p, x in ab.items():
                    x.copy_(one.adapters[n][p])
    prompt = generate_support_tickets(1, seed=44)[0]["prompt"]
    p_ids, p_mask, comps = (share_from_rank0(x, dev) for x in one.rollout(prompt)[:3])
    comp_mask = grpo.completion_token_mask(comps)
    adv = torch.tensor([1.0, -1.0] * 4, device=dev)
    greedy = _greedy_agreement(one, sides["tp2"][0], dev)
    out = {"batch": list(p_ids.shape), "completion_tokens": int(comp_mask.sum())}
    runs = {}
    for tr in (one, one32):
        with torch.no_grad():
            ref = grpo._completion_logps(tr.base, p_ids, p_mask, comps)
        batch = (p_ids, p_mask, comps, comp_mask, adv, ref)
        (loss, (pg, kl)), grads = tr.loss_and_grads(tr.adapters, *batch)
        runs[id(tr)] = (batch, {"loss": float(loss), "pg": float(pg), "kl": float(kl)}, grads)
    out["one_rank"] = runs[id(one)][1]
    for tag, (tr, alone) in sides.items():
        batch, want, grads = runs[id(alone)]
        a0 = attention_launches()
        with _q_shapes() as shapes:
            (loss, (pg, kl)), g = tr.loss_and_grads(tr.adapters, *batch)
        got = {"loss": float(loss), "pg": float(pg), "kl": float(kl)}
        cos = {f"{n}.{p}": float(torch.nn.functional.cosine_similarity(
            g[n][p].double().flatten(), grads[n][p].double().flatten(), dim=0)) for n in g for p in ("a", "b")}
        tr._update(g)
        out[tag] = {**got, "rel_diff": {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in got},
                    "grad_cosine": cos, "grad_cosine_min": min(cos.values()),
                    "loss_pass_attention": attention_launches() - a0, "q_shapes": sorted(shapes),
                    "adapter_crc": _adapter_crcs(tr.adapters)}
    out["tp2"].update(greedy)
    out["seconds"] = time.perf_counter() - t0
    report["4-layer checks"] = out
    del whole, whole32, one, one32, sides, runs
    torch.cuda.empty_cache()


def grpo_rank(out: Path) -> int:
    """One rank of phase 11, started by torchrun: parts 1-3 (see
    ``phase_tp_grpo``); its report goes to ``out/rank<r>.json``."""
    import torch.distributed as dist

    from multimodal_embedding_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed("cuda:0", timeout_s=300)  # gloo: both ranks share the card
    rank = dist.get_rank()
    report = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    _rank_tp_training(dev, report)
    _rank_cut_checks(dev, report)
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_tp_grpo(kernels: list[dict]) -> None:
    """Phase 11: Workload B on a (data, model) mesh, two ranks on the one
    H100 through gloo (``cuda:0``), launched by torchrun; then
    ``dryrun_multichip(2)`` on the card. The kernels were built by phase 1."""
    import os
    import shutil
    import signal

    import torch

    from multimodal_embedding_tpu_torch.dryrun import dryrun_multichip
    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B

    out = OUT_DIR / "tp_grpo"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    card = card_line()
    gc.collect()  # the ranks need 38 GB each of the card this process shares
    torch.cuda.empty_cache()
    parent_reserved, free = torch.cuda.memory_reserved(), torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(TP_GRPO_RANKS),
           str(ROOT / "chip_smoke.py"), "--grpo-rank", str(out)]
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    proc = subprocess.Popen(cmd, cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TP_GRPO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and both ranks
        log, _ = proc.communicate()
    (out / "torchrun.log").write_text(log)
    if proc.returncode != 0:
        print(log[-6000:])
    require(proc.returncode == 0, f"phase 11: torchrun exited {proc.returncode}")
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(TP_GRPO_RANKS)]
    for rep in reports:
        print(f"[tp_grpo] rank {rep['rank']}: " + json.dumps({k: v for k, v in rep.items() if k != "rank"}))
    L = QWEN3_14B.layers
    total = torch.cuda.get_device_properties(0).total_memory
    for rep in reports:
        require(rep["backend"] == "gloo" and rep["device"] == "cuda:0", f"rank layout {rep}")
        tr, cut = rep["tp2 qwen3-14b"], rep["4-layer checks"]
        (part,) = tr["per_prompt"]
        require(part["rollout_attention"] == part["ref_attention"] == part["loss_fwd_bwd_attention"] == L
                and tr["optimizer_steps"] == 1,
                f"rank {rep['rank']} 40-layer TP step {part}, {tr['optimizer_steps']} steps")
        require([tuple(x) for x in tr["q_shapes"]] == TP_SHAPES,
                f"rank {rep['rank']} attention shapes {tr['q_shapes']}")
        require(all(math.isfinite(tr["stats"][k][0]) for k in ("loss", "kl")), f"TP GRPO stats {tr['stats']}")
        tp, dp = cut["tp2"], cut["dp2"]
        require(tp["grad_cosine_min"] >= TP_GRAD_COSINE_MIN and max(tp["rel_diff"].values()) <= TP_LOSS_REL_TOL
                and tp["teacher_forced_argmax_equal"] >= TP_GREEDY_EQUAL_MIN,
                f"rank {rep['rank']} TP 2 against one rank: cosine {tp['grad_cosine']}, loss terms {tp['rel_diff']}, "
                f"greedy tokens equal {tp['teacher_forced_argmax_equal']} a position "
                f"({tp['greedy_equal']} free-running)")
        require(tp["loss_pass_attention"] == CONSISTENCY_LAYERS
                and [tuple(x) for x in tp["q_shapes"]] == [TP_SHAPES[1]],
                f"TP 2 loss pass launches {tp['loss_pass_attention']}, shapes {tp['q_shapes']}")
        require(dp["grad_cosine_min"] >= DP_GRAD_COSINE_MIN and dp["rel_diff"]["loss"] <= DP_LOSS_REL_TOL,
                f"rank {rep['rank']} DP 2 against one rank: cosine {dp['grad_cosine']}, loss {dp['rel_diff']}")
    for key in (("tp2 qwen3-14b",), ("4-layer checks", "tp2"), ("4-layer checks", "dp2"),
                ("4-layer checks", "dp2 bf16")):
        crcs = []
        for rep in reports:
            node = rep
            for k in key:
                node = node[k]
            crcs.append(node["adapter_crc"])
        require(all(c == crcs[0] for c in crcs), f"{key}: adapters differ across ranks after the step: {crcs}")
    peaks = [rep["tp2 qwen3-14b"]["peak_bytes"] for rep in reports]
    require(sum(peaks) < total, f"peak device memory a rank {peaks}, of {total}")
    torchrun_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dry = dryrun_multichip(TP_GRPO_RANKS)
    dry_s = time.perf_counter() - t1
    require(dry["device"] == "cuda:0" and all(math.isfinite(dry[k]) for k in ("loss", "qwen3_loss")), f"dryrun {dry}")
    require(dry["launches"] == DRYRUN_LAUNCHES, f"dryrun launches {dry['launches']}, want {DRYRUN_LAUNCHES}")
    step = {k: reports[0]["tp2 qwen3-14b"][k] for k in ("build_s", "train_s", "per_prompt")}
    print(f"[tp_grpo] two processes time-slicing one card, collectives through host memory (gloo): not a scaling "
          f"figure; the 40-layer TP 2 step {json.dumps(step)}, "
          f"peak a rank {peaks} of {total} ({free} free as the ranks started, this process holding "
          f"{parent_reserved}); torchrun {torchrun_s:.1f} s; "
          f"dryrun_multichip(2) {dry_s:.1f} s, "
          f"launches {json.dumps(dry['launches'])}; card {card}")
    for k in kernels:
        name = k["name"]
        attention = name == "fused_attention"
        k["launches_by_path"]["qwen3-14b grpo tp2"] = (
            reports[0]["tp2 qwen3-14b"]["attention_launches"] if attention else 0)
        k["launches_by_path"]["qwen3-14b 4-layer tp2, dp2 (f32, bf16) loss passes"] = (
            sum(reports[0]["4-layer checks"][t]["loss_pass_attention"] for t in ("tp2", "dp2", "dp2 bf16"))
            if attention else 0)
        k["launches_by_path"]["dryrun_multichip(2)"] = dry["launches"].get(name, 0)
    print(f"[phase11] {time.perf_counter() - t0:.1f} s")


# --- phase 12: the f32 kernels' paths at full width ------------------------------------

F32_GENERATE_BATCH, F32_GENERATE_NEW = 64, 8
F32_COSINE_MIN = 0.99999  # the f32 attention kernel against the plain path, both sides f32


def _count_launches(fn):
    """(fn(), every launch count over the call): each count set to 0 just
    before and read just after."""
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    return out, launch_counts()


def _f32_index_search(dev) -> dict:
    """``retrieval/search.Index`` at COCO-5k size in f32: seeded,
    token-normalized synthetic embeddings made on the card (5000 docs of
    1030 tokens, 64 queries of 32), searched at k = 10 through the f32
    MaxSim kernel, twice (the same answer); the first 4 queries' top-10 ids
    equal to the plain path's and their scores within max|d|/max|plain|
    ``MAXSIM_REL_TOL_F32``."""
    import torch

    from multimodal_embedding_tpu_torch.ops.maxsim_cuda import maxsim_scores_ref
    from multimodal_embedding_tpu_torch.retrieval.search import Index

    gen = torch.Generator(device=dev).manual_seed(14)
    emb = torch.randn(SEARCH_DOCS, 1030, 128, generator=gen, device=dev)
    emb /= emb.norm(dim=-1, keepdim=True)
    queries = torch.randn(SEARCH_QUERIES_N, 32, 128, generator=gen, device=dev)
    queries /= queries.norm(dim=-1, keepdim=True)
    index = Index(embeddings=emb, ids=np.arange(SEARCH_DOCS) + 100_000, multi_vector=True)
    seconds, results = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (ids, top), counts = _count_launches(lambda: index.search(queries, k=10))
        seconds.append(time.perf_counter() - t0)  # search returns host arrays: synchronized
        results.append((ids, top))
    require(counts["maxsim_f32"] == 1 and counts["maxsim"] == 0, f"the f32 index search launched {counts}")
    require(np.array_equal(results[0][0], results[1][0]) and np.array_equal(results[0][1], results[1][1]),
            "two searches of the same index gave different answers")
    nc = 4
    plain = maxsim_scores_ref(queries[:nc], emb)
    plain_top, plain_idx = torch.sort(plain, dim=1, descending=True, stable=True)
    plain_ids, plain_top = index.ids[plain_idx[:, :10].cpu().numpy()], plain_top[:, :10].cpu().numpy()
    require(np.array_equal(ids[:nc], plain_ids), f"search top-10 ids {ids[:nc].tolist()} != plain {plain_ids.tolist()}")
    err = float(np.abs(top[:nc] - plain_top).max())
    rel = err / float(np.abs(plain_top).max())
    require(math.isfinite(rel) and rel <= MAXSIM_REL_TOL_F32, f"search top-10 scores: max|d|/max|plain| {rel}")
    require(ids.shape == (SEARCH_QUERIES_N, 10) and bool(np.isfinite(top).all()), f"search result {ids.shape}")
    out = {"index": [SEARCH_DOCS, 1030, 128], "queries": [SEARCH_QUERIES_N, 32, 128], "k": 10,
           "search_s": seconds, "checked_queries": nc, "top10_ids_equal": True, "max_score_abs_err": err,
           "max_score_rel_err": rel, "counts": counts}
    del emb, queries, index, plain
    torch.cuda.empty_cache()
    return out


def _qwen3_f32_generate(dev) -> dict:
    """``QWEN3_14B`` cut to 4 layers at full width in f32 (arch-random):
    the prefill (timed) and ``rl/generate.py:generate`` at batch 64, prompts
    left-padded to 256, 8 greedy tokens, through the f32 attention kernel
    and through the plain attention path on the same weights; hidden states
    at valid positions and first-token logits per-row cosine >=
    ``F32_COSINE_MIN``, greedy tokens equal, one launch a layer in each
    prefill and none while decoding."""
    import dataclasses

    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.qwen3 import QWEN3_14B, Qwen3
    from multimodal_embedding_tpu_torch.rl.generate import generate

    cfg = dataclasses.replace(QWEN3_14B, layers=CONSISTENCY_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    model = Qwen3(cfg, gen=torch.Generator(device=dev).manual_seed(4), device=dev, dtype=torch.float32)
    rng = np.random.default_rng(12)
    b, t = F32_GENERATE_BATCH, VERIFY_PROMPT_LEN
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    mask_np = (np.arange(t)[None, :] >= t - lengths[:, None]).astype(np.int32)
    ids_np = np.where(mask_np > 0, rng.integers(3, cfg.vocab_size, size=(b, t)), 0)
    ids, mask = torch.from_numpy(ids_np).to(dev), torch.from_numpy(mask_np).to(dev)
    valid = mask.bool()
    runs = {}
    for impl in ("pallas", "xla"):  # the kernel route, then the plain attention path
        with runtime.using(attention=impl), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (hidden, _), prefill_counts = _count_launches(lambda: model.prefill(ids, mask, t))
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            first = model.lm_logits(hidden[:, -1:])[:, 0]
            (toks, _), counts = _count_launches(
                lambda: generate(model, ids, mask, F32_GENERATE_NEW, greedy=True))
        runs[impl] = {"hidden": hidden[valid], "first": first, "toks": toks, "prefill_ms": prefill_ms,
                      "prefill_counts": prefill_counts, "counts": counts}
        del hidden
    k, p = runs["pallas"], runs["xla"]
    L = CONSISTENCY_LAYERS
    require(k["prefill_counts"]["fused_attention_f32"] == k["counts"]["fused_attention_f32"] == L,
            f"f32 Qwen3 launches: prefill {k['prefill_counts']}, generate {k['counts']} (want {L} each, the "
            f"generate's all in its prefill)")
    require(p["prefill_counts"]["fused_attention_f32"] == p["counts"]["fused_attention_f32"] == 0,
            "the plain attention path launched the attention kernel")
    cos_h, cos_l = _cosines(k["hidden"], p["hidden"]), _cosines(k["first"], p["first"])
    equal = float((k["toks"] == p["toks"]).float().mean())
    out = {"layers": L, "batch": b, "prompt_len": t, "new_tokens": F32_GENERATE_NEW,
           "prefill_ms": k["prefill_ms"], "plain_prefill_ms": p["prefill_ms"],
           "hidden_cosine_min": float(cos_h.min()), "valid_rows": int(valid.sum()),
           "first_logits_cosine_min": float(cos_l.min()), "greedy_tokens_equal": equal,
           "attention_launches": {"prefill": k["prefill_counts"]["fused_attention_f32"],
                                  "generate": k["counts"]["fused_attention_f32"]},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev), "counts": k["counts"]}
    require(bool(torch.isfinite(k["hidden"]).all()) and bool(torch.isfinite(k["first"]).all()),
            "non-finite f32 Qwen3 outputs")
    require(out["hidden_cosine_min"] >= F32_COSINE_MIN and out["first_logits_cosine_min"] >= F32_COSINE_MIN,
            f"f32 Qwen3-14B 4-layer kernel vs plain cosine {out} < {F32_COSINE_MIN}")
    require(equal == 1.0, f"f32 Qwen3-14B greedy tokens equal to the plain path's in {equal} of positions")
    del model, runs, k, p
    torch.cuda.empty_cache()
    return out


def phase_f32_paths(kernels: list[dict]) -> None:
    """Phase 12: the paths that run the f32 kernels, at full width."""
    import torch

    dev = torch.device("cuda")
    card = card_line()
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    search = _f32_index_search(dev)
    print(f"[phase12] f32 index search: {json.dumps(search)}; card {card}")
    qwen = _qwen3_f32_generate(dev)
    print(f"[phase12] Qwen3-14B {CONSISTENCY_LAYERS} layers f32, generate batch {F32_GENERATE_BATCH}, prompts "
          f"{VERIFY_PROMPT_LEN}, {F32_GENERATE_NEW} greedy tokens, f32 kernel vs plain: {json.dumps(qwen)}")
    for k in kernels:
        k["launches_by_path"]["f32 index search"] = search["counts"].get(k["name"], 0)
        k["launches_by_path"]["qwen3-14b 4-layer f32 generate"] = qwen["counts"].get(k["name"], 0)
        if k["name"] == "maxsim_f32":
            k["launches"] = search["counts"]["maxsim_f32"]
        elif k["name"] == "fused_attention_f32":
            k["launches"] = qwen["counts"]["fused_attention_f32"]
    print(f"[phase12] {time.perf_counter() - t_phase:.1f} s")


# --- phase 13: the contract's forward step -------------------------------------------

# per-image cosine of entry()'s bf16 kernel path against the plain path on the
# same weights in f32: phase 5's CLIP-L CLS embeddings read >= 0.99993
ENTRY_COSINE_MIN = 0.9999
# a call: one preprocess, one attention (on the kernel's warpgroup body: Dh
# 64) and one MLP activation a ViT-L layer
ENTRY_LAUNCHES = {"preprocess": 1, "fused_attention": 24, "mlp_activation": 24, "fused_attention_wgmma": 24}


def phase_entry(kernels: list[dict]) -> None:
    """Phase 13: ``entry()`` with no arguments, then ``fn(*args)`` once
    (its launches counted) and 10 times under CUDA events; the embeddings
    against the plain path (plain preprocess, ``xla`` attention) on the same
    weights cast to f32."""
    import copy

    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.entry import IMAGE_H, IMAGE_W, entry
    from multimodal_embedding_tpu_torch.models import layers
    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.ops import launch_counts, reset_launch_counts
    from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn, args = entry()
    model, images = args
    require(images.is_cuda and images.dtype == torch.uint8 and tuple(images.shape) == (8, 3, IMAGE_H, IMAGE_W),
            f"entry() images {images.dtype} {tuple(images.shape)} on {images.device}")
    reset_launch_counts()
    emb = fn(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {n: ENTRY_LAUNCHES.get(n, 0) for n in counts}
    require(counts == want, f"entry() launches a call {counts}, want {want}")
    dim = model.cfg.vision.proj_dim
    norms = emb.norm(dim=-1)
    require(tuple(emb.shape) == (8, dim) and emb.dtype == torch.float32 and bool(emb.isfinite().all())
            and float((norms - 1).abs().max()) < 1e-5, f"entry() output {emb.dtype} {tuple(emb.shape)}, norms {norms}")
    ms = cuda_time_ms(lambda: fn(*args), iters=10, warmup=0)
    dev_ms = device_ms(lambda: fn(*args))
    peak = torch.cuda.max_memory_allocated()

    model32 = copy.deepcopy(model).float()
    plain_pre = make_preprocess_fn(model_info("OpenAI-CLIP-L").preprocess, IMAGE_H, IMAGE_W, device="cuda",
                                   input_format="nchw")
    with runtime.using(attention="xla"), torch.inference_mode():
        plain = layers.l2_normalize(model32.encode_image(plain_pre(images)))
    cos = torch.nn.functional.cosine_similarity(emb, plain, dim=-1)
    out = {"batch": 8, "image": [IMAGE_H, IMAGE_W], "embedding": [8, dim], "ms": ms, "device_ms": dev_ms,
           "img_per_s": 8e3 / ms, "peak_memory_bytes": peak, "launches_per_call": counts,
           "cosine_vs_plain_f32": [round(float(c), 6) for c in cos]}
    print(f"[entry] {json.dumps(out)}; card {card_line()}")
    require(bool((cos >= ENTRY_COSINE_MIN).all()), f"entry() cosine {float(cos.min())} < {ENTRY_COSINE_MIN}")
    for k in kernels:
        k["launches_by_path"]["entry()"] = counts.get(k["name"], 0)
    del fn, args, model, images, model32
    torch.cuda.empty_cache()
    print(f"[phase13] {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    import multimodal_embedding_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    args = sys.argv[1:]
    if args[:1] == ["--parallel-rank"]:  # one of phase 10's ranks, started by torchrun
        return parallel_rank(Path(args[1]))
    if args[:1] == ["--grpo-rank"]:  # one of phase 11's ranks, started by torchrun
        return grpo_rank(Path(args[1]))
    if args == ["--attention-cases"]:
        args = ["--cases", "attention"]
    if args:
        if len(args) != 2 or args[0] != "--cases":
            print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
            return 2
        print(card_line())
        return run_cases(args[1].split(","))
    t0 = time.perf_counter()
    phase_build()
    kernels = phase_kernels()
    phase_main_path(kernels)
    phase_bench_and_consistency()
    phase_colpali_consistency()
    phase_other_models_consistency()
    phase_converted(kernels)
    phase_workload_a(kernels)
    phase_workload_b(kernels)
    phase_workload_b_training(kernels)
    phase_parallel(kernels)
    phase_tp_grpo(kernels)
    phase_f32_paths(kernels)
    phase_entry(kernels)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
