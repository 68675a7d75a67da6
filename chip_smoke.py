#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):
  1. build the CUDA kernels of ``multimodal_embedding_tpu_torch/csrc`` (one
     nvcc per source, all at once) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the tolerances stated below, and time both,
     the one PyTorch library call that computes the same function (where
     there is one) and the least time the card could take (``bound_ms``);
  3. the main path at full width: the port's CLI in-process on the synthetic
     dataset with OpenAI-CLIP-L at its published architecture and random
     weights; the launch counts are set to 0 just before and read just after;
  4. a bench-shaped throughput line (bench.py's run_once: 288 images of
     480x640, batch 96, three timed passes from the staged cache);
  5. full-width consistency: CLS embeddings of 8 images through the kernels
     in bf16 against the plain versions in f32, per-row cosine >= 0.999.

The last three lines are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Imports only the port, torch
and numpy.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
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
COSINE_MIN = 0.999

CLI_ARGS = [
    "--dataset", "synthetic", "--arch-models", "--models", "OpenAI-CLIP-L",
    "--sample-size", "512", "--bootstrap-iterations", "200", "--batch-size", "64",
]
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


# --- phase 1 -------------------------------------------------------------------


def phase_build() -> float:
    from multimodal_embedding_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built in {dt:.1f} s")
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


# --- phase 2 -------------------------------------------------------------------


def _attention_case(name, *, b, h, kvh, t, dh, dtype, causal, masked, layout, full_mask_rows, rng):
    import torch
    import torch.nn.functional as F

    from multimodal_embedding_tpu_torch.ops import attention_cuda
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    if layout == "packed":
        q, k, v = rand((b, t, h * dh)), rand((b, t, kvh * dh)), rand((b, t, kvh * dh))
    else:
        q, k, v = rand((b, h, t, dh)), rand((b, kvh, t, dh)), rand((b, kvh, t, dh))
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
        o4 = out if layout == "bhtd" else out.reshape(b, t, h, dh).transpose(1, 2)
        require(bool((o4[-1] == 0).all()), f"attention {name}: fully masked sequence not exact zeros")
        if causal:
            require(bool((o4[0, :, 0] == 0).all()), f"attention {name}: fully masked row not exact zeros")

    ms = cuda_time_ms(lambda: attention_cuda.fused_attention(q, k, v, km, **kw))
    plain_ms = cuda_time_ms(lambda: attention_cuda._plain(q, k, v, km, causal, scale, layout, h, kvh))

    def bhtd(x, nh):
        return x if layout == "bhtd" else x.reshape(b, t, nh, dh).transpose(1, 2)

    q4, k4, v4 = bhtd(q, h), bhtd(k, kvh), bhtd(v, kvh)
    if kvh != h:
        k4, v4 = k4.repeat_interleave(h // kvh, 1), v4.repeat_interleave(h // kvh, 1)
    valid = torch.ones(b, 1, t, t, dtype=torch.bool, device=dev)
    if km is not None:
        valid = valid & km.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    attn_mask = valid if (masked or causal) else None
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask))

    es = q.element_size()
    pairs = float(valid.sum()) * h  # (batch, head, query, key) pairs the function needs
    flops = 4.0 * pairs * dh
    nbytes = es * dh * (2 * b * t * h + 2 * b * t * kvh) + (b * t if km is not None else 0)
    bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    case = {"case": name, "shape": [b, h, kvh, t, dh], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_rel_err": max_rel, "mean_rel_err": mean_rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}
    print(f"[attention] {json.dumps(case)}")
    return case


def _preprocess_case(h, w, b, rng):
    import torch

    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn, scale_shift
    from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn, preprocess_weights
    from multimodal_embedding_tpu_torch.utils.timing import cuda_time_ms

    cfg = model_info("OpenAI-CLIP-L").preprocess
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
    plain_ms = cuda_time_ms(lambda: plain(x))
    # the multiply-adds these weights need: the nonzero bands of both passes
    flops = 2.0 * 3 * b * preprocess_weights(cfg, h, w, "cpu").taps
    nbytes = b * 3 * h * w + b * c * c * 3 * 4
    bms, by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    case = {"case": f"{h}x{w}->{c}", "shape": [b, 3, h, w], "bit_equal": bit_equal,
            "max_abs_err": max(per_ch), "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by}
    print(f"[preprocess] {json.dumps(case)}")
    return case


def phase_kernels() -> list[dict]:
    import torch

    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    attn = [
        _attention_case("vit-l packed", b=64, h=16, kvh=16, t=577, dh=64, dtype=bf16, causal=False,
                        masked=False, layout="packed", full_mask_rows=False, rng=rng),
        _attention_case("clip-l text packed causal+mask", b=128, h=12, kvh=12, t=77, dh=64, dtype=bf16,
                        causal=True, masked=True, layout="packed", full_mask_rows=False, rng=rng),
        _attention_case("gqa bhtd causal+mask, fully masked rows", b=4, h=8, kvh=2, t=100, dh=64,
                        dtype=bf16, causal=True, masked=True, layout="bhtd", full_mask_rows=True, rng=rng),
        _attention_case("f32 packed causal+mask", b=4, h=4, kvh=4, t=77, dh=64, dtype=torch.float32,
                        causal=True, masked=True, layout="packed", full_mask_rows=True, rng=rng),
    ]
    pre = [_preprocess_case(h, w, 64, rng) for (h, w) in ((480, 640), (640, 480), (480, 480), (427, 640))]
    root = "multimodal_embedding_tpu_torch/csrc"
    return [
        {"name": "fused_attention", "route": "cuda", "source": f"{root}/attention.cu",
         "replaces": "multimodal_embedding_tpu/ops/attention_pallas.py:219", **_headline(attn[0]),
         "cases": attn},
        {"name": "preprocess", "route": "cuda", "source": f"{root}/preprocess.cu",
         "replaces": "multimodal_embedding_tpu/ops/preprocess_pallas.py:57", **_headline(pre[0]),
         "cases": pre},
    ]


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"launches": 0, **{k: case[k] for k in keys}}


# --- phase 3 -------------------------------------------------------------------


def phase_main_path(kernels: list[dict]) -> None:
    import pandas as pd

    from multimodal_embedding_tpu_torch.cli.main import main as cli_main
    from multimodal_embedding_tpu_torch.ops import attention_cuda, preprocess_cuda

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / "main_path.csv"
    out.unlink(missing_ok=True)
    attention_cuda.launches = 0
    preprocess_cuda.launches = 0
    rc = cli_main([*CLI_ARGS, "--output", str(out)])
    counts = {"fused_attention": attention_cuda.launches, "preprocess": preprocess_cuda.launches}
    require(rc == 0, f"main path CLI exited {rc}")
    df = pd.read_csv(out)
    require(list(df.columns) == REFERENCE_COLUMNS, f"CSV columns {list(df.columns)}")
    row = df.iloc[0]
    for col in REFERENCE_COLUMNS[2:-5]:
        require(0.0 <= float(row[col]) <= 100.0 or col.endswith("_std"), f"{col} = {row[col]} outside [0, 100]")
    require(float(row["QPS"]) > 0, f"QPS {row['QPS']}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        require(k["launches"] > 0, f"kernel {k['name']} was not launched on the main path")
    print(f"[main] {row['Model']} weights={row['Weights']} QPS={float(row['QPS'])} "
          f"Encoding_Time={float(row['Encoding_Time'])} T2I_R@1={float(row['T2I_R@1_mean'])} "
          f"launches={json.dumps(counts)}")


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

    # phase 5: the same weights, kernels in bf16 vs plain versions in f32
    few = images[:8]
    emb_kernel = engine.encode_images(few).embeddings
    model32 = copy.copy(model)
    model32.model = copy.deepcopy(model.model).float()
    layers.set_attention_impl("xla")  # the unmasked vision tower: the kernel's plain function
    plain_engine = EncodingEngine(model32, batch_size=8, device=dev, preprocess_impl="xla")
    emb_plain = plain_engine.encode_images(few).embeddings
    layers.set_attention_impl("auto")
    cos = torch.nn.functional.cosine_similarity(emb_kernel.float(), emb_plain.float(), dim=-1)
    print(f"[consistency] per-image cosine kernel-bf16 vs plain-f32: {[round(float(c), 6) for c in cos]}")
    require(bool((cos >= COSINE_MIN).all()), f"cosine {float(cos.min())} < {COSINE_MIN}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    import multimodal_embedding_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    kernels = phase_kernels()
    phase_main_path(kernels)
    phase_bench_and_consistency()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
