#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --cases maxsim,preprocess    # the build and these phase-2 cases only
    python3 chip_smoke.py --attention-cases            # the same as --cases attention

Phases, each of which fails the run (nonzero exit, no result line):
  1. build the CUDA kernels of ``multimodal_embedding_tpu_torch/csrc`` (one
     nvcc per source, all at once) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (OpenAI-CLIP-L, ColPali-v1.3 and the fused encoder
     layer's; the ViT-H and SigLIP-So400m towers, the MAP head's one probe
     row over 729 keys, and the four other models' preprocess recipes; plus
     attention at a 4096-key row, and MaxSim at a fifth of COCO-5k's I2T,
     checked on its first 64 queries),
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
     loads; each model's launch counts are set to 0 just before its
     benchmark and read just after, every kernel of its path must have
     launched (Jina's towers have no attention kernel route: preprocess
     only), and its QPS and peak device memory are printed;
  4. a bench-shaped throughput line (bench.py's run_once: 288 images of
     480x640, batch 96, three timed passes from the staged cache);
  5. full-width consistency: CLS embeddings of 8 images through the kernels
     in bf16, under both layer impls, against the plain versions in f32,
     per-row cosine >= 0.999; ColPali per-token embeddings of 2 images and 4
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
     debug flag scores both models from that cache (``Weights`` = real).

The last three lines are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Imports only the port, torch
and numpy.
"""

from __future__ import annotations

import functools
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

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM data-sheet peaks (dense, no sparsity), at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

ATTN_TOL_BF16 = 2e-2  # bf16 kernel vs the f32 plain version on the same bf16 inputs
ATTN_TOL_F32 = 1e-5
# Relative limits, max|d|/max|plain| and mean|d|/mean|plain|. Rounding p and
# the output to bf16 gives about 0.4% and 0.2% at the ViT-L and text shapes;
# one valid key dropped from each row gives about 26% and 2.5% at ViT-L, which
# the absolute limit alone need not see where outputs are small.
ATTN_REL_TOL_BF16 = 1e-2
ATTN_REL_TOL_F32 = 1e-5
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
COSINE_MIN = 0.999
# ColPali per-token cosine, kernels in bf16 vs plain versions in f32: 27
# SigLIP and 18 Gemma layers of bf16 rounding at full width.
COLPALI_COSINE_MIN = 0.99

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


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def _attention_case(name, *, b, h, kvh, t, dh, dtype, causal, masked, layout, full_mask_rows, rng, tq=None):
    """``tq`` query rows (default ``t``) against ``t`` keys."""
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
        km_np = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
        if full_mask_rows:
            km_np[-1] = 0  # every query row of the last sequence is fully masked
            km_np[0, 0] = 0  # with causal, query row 0 of sequence 0 is fully masked
        km = torch.from_numpy(km_np).to(dev)
    kw = dict(causal=causal, layout=layout, num_heads=h, num_kv_heads=kvh)

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

    ms = cuda_time_ms(lambda: attention_cuda.fused_attention(q, k, v, km, **kw))
    dev_ms = device_ms(lambda: attention_cuda.fused_attention(q, k, v, km, **kw))
    plain_ms = cuda_time_ms(lambda: attention_cuda._plain(q, k, v, km, causal, scale, layout, h, kvh))

    def bhtd(x, nh, n):
        return x if layout == "bhtd" else x.reshape(b, n, nh, dh).transpose(1, 2)

    q4, k4, v4 = bhtd(q, h, tq), bhtd(k, kvh, t), bhtd(v, kvh, t)
    if kvh != h:
        k4, v4 = k4.repeat_interleave(h // kvh, 1), v4.repeat_interleave(h // kvh, 1)
    valid = torch.ones(b, 1, tq, t, dtype=torch.bool, device=dev)
    if km is not None:
        valid = valid & km.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(tq, t, dtype=torch.bool, device=dev).tril()
    attn_mask = valid if (masked or causal) else None
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask))

    es = q.element_size()
    pairs = float(valid.sum()) * h  # (batch, head, query, key) pairs the function needs
    flops = 4.0 * pairs * dh
    nbytes = es * dh * (2 * b * tq * h + 2 * b * t * kvh) + (b * t if km is not None else 0)
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    case = {"case": name, "shape": [b, h, kvh, t, dh], "queries": tq, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by, "tflops": flops / (ms * 1e9), "device_ms": dev_ms}
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
    bms, by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
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
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    case = {"case": name, "shape": [nq, tq, nd, td, dim], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_rel_err": rel, "checked_queries": nc, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms, "bound_by": by,
            "tflops": None if dev_ms is None else flops / (dev_ms * 1e9)}
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
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
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
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask))
    pairs = float(valid.sum()) * h
    flops = 4.0 * pairs * dh
    nbytes = qkv.element_size() * dh * 4 * b * t * h + (b * t if km is not None else 0)
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    case = {"case": name, "shape": [b, t, 3 * h * dh], "heads": h, "dtype": str(dtype).replace("torch.", ""),
            "bit_equal_to_fused_attention": True, "max_abs_err": err, "max_rel_err": max_rel,
            "mean_rel_err": mean_rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by, "tflops": flops / (ms * 1e9), "device_ms": dev_ms}
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
    bms, by = bound_ms(8.0 * m * d, nbytes, PEAK_F32_FLOPS)
    case = {"case": name, "shape": [m, d], "dtype": str(dtype).replace("torch.", ""), "eps": eps,
            "max_abs_err": err, "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_device_ms": library_dev_ms, "bound_ms": bms,
            "bound_by": by}
    print(f"[layernorm] {json.dumps(case)}")
    return case


def attention_cases() -> list[tuple[str, dict]]:
    import torch

    bf16 = torch.bfloat16
    return [
        ("vit-l packed", dict(b=64, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
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
    ]


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


def preprocess_cases() -> list[tuple[str, dict]]:
    cases = [(f"OpenAI-CLIP-L shortest_edge {h}x{w}->336", dict(h=h, w=w, b=64))
             for (h, w) in ((480, 640), (640, 480), (480, 480), (427, 640))]
    cases.append(("ColPali-v1.3 exact 480x640->448", dict(h=480, w=640, b=8, model="ColPali-v1.3")))
    # the other models' recipes (MetaCLIP-H14's is LAION-CLIP-H's)
    for model, recipe, size in (("LAION-CLIP-H", "shortest_edge", 224), ("Apple-DFN5B-H", "shortest_edge", 378),
                                ("SigLIP-400M", "exact", 384), ("Jina-CLIP-v1", "exact bicubic", 224)):
        cases.append((f"{model} {recipe} 480x640->{size}", dict(h=480, w=640, b=32, model=model)))
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
    ]


# --cases names: (case list, the function that runs one case, its print tag)
CASE_SETS = {
    "preprocess": (preprocess_cases, "_preprocess_case", "preprocess"),
    "maxsim": (maxsim_cases, "_maxsim_case", "maxsim"),
    "attention": (attention_cases, "_attention_case", "attention"),
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
    pre = [_preprocess_case(name, **kw, rng=rng) for name, kw in preprocess_cases()]
    maxsim = [_maxsim_case(name, **kw, rng=rng) for name, kw in maxsim_cases()]
    torch.cuda.empty_cache()
    prologue = [_prologue_case(name, **kw, rng=rng) for name, kw in prologue_cases()]
    attn_qkv = [
        _attention_qkv_case("vit-l b64 stacked", b=64, h=16, t=577, dh=64, dtype=bf16, causal=False, masked=False,
                            full_mask_rows=False, rng=rng),
        _attention_qkv_case("clip text b128 stacked causal+mask", b=128, h=12, t=77, dh=64, dtype=bf16,
                            causal=True, masked=True, full_mask_rows=False, rng=rng),
        _attention_qkv_case("siglip-448 b8 stacked", b=8, h=16, t=1024, dh=72, dtype=bf16, causal=False,
                            masked=False, full_mask_rows=False, rng=rng),
        _attention_qkv_case("f32 stacked causal+mask, fully masked rows", b=4, h=4, t=77, dh=64,
                            dtype=torch.float32, causal=True, masked=True, full_mask_rows=True, rng=rng),
    ]
    ln = [_layer_norm_case(name, **kw, rng=rng) for name, kw in layernorm_cases()]
    root = "multimodal_embedding_tpu_torch/csrc"
    return [
        {"name": "fused_attention", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:219", **_headline(attn[0]),
         "cases": attn},
        {"name": "preprocess", "route": "cuda", "source": f"{root}/preprocess.cu",
         "replaces": "multimodal_embedding_tpu/ops/preprocess_pallas.py:57", **_headline(pre[0]),
         "cases": pre},
        {"name": "maxsim", "route": "cuda", "source": f"{root}/maxsim.cu",
         "replaces": "multimodal_embedding_tpu/ops/maxsim.py:128", **_headline(maxsim[0]),
         "cases": maxsim},
        {"name": "fused_res_norm_matmul", "route": "cuda", "source": f"{root}/fused_ln_matmul.cu",
         "replaces": "multimodal_embedding_tpu/ops/fused_ln_matmul.py:167", **_headline(prologue[0]),
         "cases": prologue},
        {"name": "fused_attention_qkv", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:399", **_headline(attn_qkv[0]),
         "cases": attn_qkv},
        {"name": "fused_layer_norm", "route": "cuda", "source": f"{root}/layernorm.cu",
         "replaces": "multimodal_embedding_tpu/ops/layernorm_pallas.py:38",
         "path": "none (no path in the JAX package)", **_headline(ln[0]), "cases": ln},
    ]


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"launches": 0, **{k: case[k] for k in keys}}


# --- phase 3 -------------------------------------------------------------------


def _counters() -> dict:
    """Kernel name -> (module, attribute) of its plain launch count."""
    from multimodal_embedding_tpu_torch.ops import (
        attention_cuda,
        fused_ln_matmul_cuda,
        layernorm_cuda,
        maxsim_cuda,
        preprocess_cuda,
    )

    return {"fused_attention": (attention_cuda, "launches"), "preprocess": (preprocess_cuda, "launches"),
            "maxsim": (maxsim_cuda, "launches"), "fused_res_norm_matmul": (fused_ln_matmul_cuda, "launches"),
            "fused_attention_qkv": (attention_cuda, "qkv_launches"), "fused_layer_norm": (layernorm_cuda, "launches")}


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

    counters = _counters()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / csv_name
    out.unlink(missing_ok=True)
    runs: list[dict] = []
    load, bench, compute = cli._load, cli.run_bootstrap_benchmark, cli.compute_score_matrices

    def loading(info, *a, **kw):
        runs.append({"model": info.name, "in_use_before_load": torch.cuda.memory_allocated(), "scores": []})
        return load(info, *a, **kw)

    def benchmarking(*a, **kw):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        try:
            return bench(*a, **kw)
        finally:
            runs[-1]["counts"] = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
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


def phase_main_path(kernels: list[dict]) -> None:
    import torch

    from multimodal_embedding_tpu_torch.models import layers

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
    try:
        (fused,) = _main_path([*CLI_ARGS, "--layer-impl", "fused"], "main_path_fused.csv",
                              lambda m: ("fused_res_norm_matmul", "fused_attention_qkv", "preprocess"))
    finally:
        layers.set_layer_impl("auto")
    fused_row, fused_counts = fused["row"], fused["counts"]
    # every encoder layer of both towers: one stacked-QKV attention where the
    # xla layer ran one fused_attention, and two prologues (24 x 2 per image
    # batch, 12 x 2 per text batch)
    layer_runs = clip_counts["fused_attention"]
    require(fused_counts["fused_attention_qkv"] == layer_runs and fused_counts["fused_attention"] == 0
            and fused_counts["fused_res_norm_matmul"] == 2 * layer_runs,
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
    require(jina["fused_attention"] == 0, f"Jina-CLIP-v1 launched the attention kernel: {jina}")
    print("[main] other models: " + "; ".join(
        f"{r['model']} QPS={float(r['row']['QPS'])} peak_memory_GB={r['peak_bytes'] / 1e9:.3f} "
        f"attention={r['counts']['fused_attention']} preprocess={r['counts']['preprocess']}" for r in others))
    paths = {"OpenAI-CLIP-L": clip_counts, "ColPali-v1.3": counts, "OpenAI-CLIP-L fused": fused_counts,
             **{r["model"]: r["counts"] for r in others}}
    for k in kernels:
        # each kernel's launches on the path that runs it: ColPali for
        # attention, preprocess and MaxSim, the fused CLIP-L path for the
        # prologue and stacked-QKV attention; no path runs fused_layer_norm (0)
        k["launches"] = (fused_counts if k["name"] in ("fused_res_norm_matmul", "fused_attention_qkv",
                                                       "fused_layer_norm") else counts)[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    torch.cuda.empty_cache()


# --- phases 4 and 5 ----------------------------------------------------------------


def _bench_images(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h), ((xx + yy) * 255 // (h + w))], -1).astype(np.int16)
    return [np.clip(base + rng.integers(0, 32, (h, w, 3)), 0, 255).astype(np.uint8) for _ in range(n)]


def phase_bench_and_consistency() -> None:
    import copy

    import torch

    from multimodal_embedding_tpu_torch.models import layers
    from multimodal_embedding_tpu_torch.models.arch import load_arch_model
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images
    from multimodal_embedding_tpu_torch.utils.timing import hard_sync

    dev = torch.device("cuda")
    n_images, batch, passes = 288, 96, 3
    model = load_arch_model("OpenAI-CLIP-L", seed=0, device=dev, dtype=torch.bfloat16)
    images = _bench_images(n_images)
    layers.set_attention_impl("auto")
    engine = EncodingEngine(model, batch_size=batch, device=dev, preprocess_impl="auto")
    cache = stage_images(images, batch, dev)
    engine.encode_images_cached(cache)  # warmup pass
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(passes):
        hard_sync(engine.encode_images_cached(cache).embeddings)
    dt = time.perf_counter() - t0
    print(f"[bench] clip_l_encode_images_per_sec={passes * n_images / dt} batch={batch} "
          f"images={n_images} passes={passes} max_memory_allocated={torch.cuda.max_memory_allocated(dev)} "
          f"card={card_line()}")

    # phase 5: the same weights, kernels in bf16 (both layer impls) vs plain versions in f32
    few = images[:8]
    emb_kernel = engine.encode_images(few).embeddings
    layers.set_layer_impl("fused")
    try:
        emb_fused = engine.encode_images(few).embeddings
    finally:
        layers.set_layer_impl("auto")
    model32 = copy.copy(model)
    model32.model = copy.deepcopy(model.model).float()
    layers.set_attention_impl("xla")  # the unmasked vision tower: the kernel's plain function
    plain_engine = EncodingEngine(model32, batch_size=8, device=dev, preprocess_impl="xla")
    emb_plain = plain_engine.encode_images(few).embeddings
    layers.set_attention_impl("auto")
    cos = torch.nn.functional.cosine_similarity(emb_kernel.float(), emb_plain.float(), dim=-1)
    print(f"[consistency] per-image cosine kernel-bf16 vs plain-f32: {[round(float(c), 6) for c in cos]}")
    require(bool((cos >= COSINE_MIN).all()), f"cosine {float(cos.min())} < {COSINE_MIN}")
    cos_f = torch.nn.functional.cosine_similarity(emb_fused.float(), emb_plain.float(), dim=-1)
    cos_fx = torch.nn.functional.cosine_similarity(emb_fused.float(), emb_kernel.float(), dim=-1)
    print(f"[consistency] per-image cosine --layer-impl fused kernel-bf16 vs plain-f32: "
          f"{[round(float(c), 6) for c in cos_f]}; vs the xla-layer kernel-bf16 run: "
          f"{[round(float(c), 6) for c in cos_fx]}")
    require(bool((cos_f >= COSINE_MIN).all()), f"fused cosine {float(cos_f.min())} < {COSINE_MIN}")


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

    from multimodal_embedding_tpu_torch.models import layers
    from multimodal_embedding_tpu_torch.models.arch import load_arch_model
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    dev = torch.device("cuda")
    images = _bench_images(2)
    captions = CAPTIONS[:4]
    model = load_arch_model("ColPali-v1.3", seed=0, device=dev, dtype=torch.bfloat16)
    layers.set_attention_impl("auto")
    engine = EncodingEngine(model, batch_size=2, device=dev, preprocess_impl="auto")
    img_k = engine.encode_images(images).embeddings
    txt_k = engine.encode_texts(captions)
    model32 = copy.copy(model)
    model32.model = copy.deepcopy(model.model).float()
    del model, engine
    layers.set_attention_impl("xla")
    try:
        plain = EncodingEngine(model32, batch_size=2, device=dev, preprocess_impl="xla")
        img_p = plain.encode_images(images).embeddings
        txt_p = plain.encode_texts(captions)
    finally:
        layers.set_attention_impl("auto")
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

    from multimodal_embedding_tpu_torch.models import layers
    from multimodal_embedding_tpu_torch.models.arch import load_arch_model
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    dev = torch.device("cuda")
    images = _bench_images(8)
    for name in OTHER_MODELS:
        model = load_arch_model(name, seed=0, device=dev, dtype=torch.bfloat16)
        engine = EncodingEngine(model, batch_size=8, device=dev, preprocess_impl="auto")
        kernel = {}
        for impl in ("xla",) if name == "Jina-CLIP-v1" else ("xla", "fused"):
            layers.set_layer_impl(impl)
            try:
                kernel[impl] = (engine.encode_images(images).embeddings, engine.encode_texts(CAPTIONS).embeddings)
            finally:
                layers.set_layer_impl("auto")
        model32 = copy.copy(model)
        model32.model = copy.deepcopy(model.model).float()
        del model, engine
        layers.set_attention_impl("xla")
        try:
            plain = EncodingEngine(model32, batch_size=8, device=dev, preprocess_impl="xla")
            img_p, txt_p = plain.encode_images(images).embeddings, plain.encode_texts(CAPTIONS).embeddings
        finally:
            layers.set_attention_impl("auto")
        del model32, plain
        torch.cuda.empty_cache()
        for impl, (img_k, txt_k) in kernel.items():
            cos_img = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(), dim=-1)
            cos_txt = torch.nn.functional.cosine_similarity(txt_k.float(), txt_p.float(), dim=-1)
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


def _encode(model, images, impl: str, preprocess_impl: str = "auto"):
    from multimodal_embedding_tpu_torch.models import layers
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine

    engine = EncodingEngine(model, batch_size=8, device="cuda", preprocess_impl=preprocess_impl)
    layers.set_layer_impl(impl)
    try:
        return engine.encode_images(images).embeddings, engine.encode_texts(CAPTIONS)
    finally:
        layers.set_layer_impl("auto")


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

    from multimodal_embedding_tpu_torch.models import layers, zoo
    from multimodal_embedding_tpu_torch.models.arch import arch_tokenizer, full_arch_config
    from multimodal_embedding_tpu_torch.models.checkpoint import load_params, save_params

    mem = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("[converted] host memory (free -g): " + " | ".join(" ".join(line.split()) for line in mem.splitlines()))
    card = card_line()
    images = _bench_images(8)
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
            layers.set_attention_impl("xla")  # the kernels' plain functions
            try:
                img_p, txt_p = _encode(model32, images, "xla", preprocess_impl="xla")
            finally:
                layers.set_attention_impl("auto")
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
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
