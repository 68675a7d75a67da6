"""A benchmark tree at toy sizes for the CPU tests: debug-width towers of
both families, a few small images, few rounds. ``make_root(tmp)`` writes
``BENCHMARK.json`` and ``perfbench/`` (the repository's drivers and
metrics, tiny configurations, traffic mixes and limits) under ``tmp``."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from perfbench.harness import ROOT

REPO = ROOT / "perfbench"


def _tower(cfg: dict, family: str) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["name"] = f"tiny-{family}"
    for key in ("vision_config", "text_config"):
        cfg[key].update(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_hidden_layers=2)
    cfg["vision_config"].update(image_size=32, patch_size=8)
    cfg["text_config"].update(max_position_embeddings=16, vocab_size=512)
    cfg["preprocess"]["image_size"] = 32
    cfg["batch_size"] = 4
    if family == "clip":
        cfg["projection_dim"] = 32
    return cfg


CONFIGS = {
    "tiny-clip": lambda: _tower(json.loads((REPO / "configs" / "clip-l.json").read_text()), "clip"),
    "tiny-siglip": lambda: _tower(json.loads((REPO / "configs" / "siglip-400m.json").read_text()), "siglip"),
}
TRAFFIC = {
    "tiny-encode": {"driver": "encode", "images": 10, "caches": 2, "geometries": [[24, 32], [32, 24]],
                    "captions_per_image": 5, "trace_units": 1,
                    "check": {"rounds": 2, "images": 5, "t2i_captions": 5, "captions": 25}},
    "tiny-stats": {"driver": "stats", "images": 400, "captions_per_image": 5, "noise": 0.3, "iterations": 6,
                   "trace_units": 1, "check": {"rounds": 2}},
    "tiny-search": {"driver": "search", "index": 50, "k": 5, "min_queries": 1, "max_queries": 4,
                    "max_requests": 400, "pool_records": 20, "trace_units": 3, "check": {"requests": 6}},
}
CELLS = [("tiny-clip.tiny-encode", "tiny-clip", "tiny-encode"),
         ("tiny-siglip.tiny-encode", "tiny-siglip", "tiny-encode"),
         ("tiny-clip.tiny-stats", "tiny-clip", "tiny-stats"),
         ("tiny-clip.tiny-search", "tiny-clip", "tiny-search")]
# The metrics of the statistics and search cells: their files are in
# perfbench/, their entries are held out of BENCHMARK.json (PERF.md section
# 7), so the toy tree adds them.
HELD_OUT_METRICS = {
    "end_to_end": [{"name": n, "unit": u, "better": b, "bound": 0.25, "source": "host_clock", "workloads": []}
                   for n, u, b in (("bootstrap_iter_per_s", "iter/s", "higher"), ("search_p95_ms", "ms", "lower"))],
    "per_layer": [{"name": n, "unit": u, "better": b, "source": src, "layer": "toy", "moves": moves, "workloads": []}
                  for n, u, b, src, moves in (
                      ("mfu_pct.stats", "%", "higher", "device_trace", "bootstrap_iter_per_s"),
                      ("device_idle_pct.stats", "%", "lower", "device_trace", "bootstrap_iter_per_s"),
                      ("mfu_pct.search", "%", "higher", "device_trace", "search_p95_ms"),
                      ("device_idle_pct.search", "%", "lower", "device_trace", "search_p95_ms"),
                      ("text_encode_p50_ms.search", "ms", "lower", "program_span", "search_p95_ms"))],
}
# Limits at the toy sizes on the CPU: the bf16 port against the f32
# reference reads about a tenth of these (perfbench/tests/test_perfbench_check.py).
LIMITS = {
    "tiny-encode": {"image_cos_gap": 2e-4, "text_cos_gap": 2e-4, "score_gap": 2e-2},
    "tiny-stats": {"recall_gap_pp": 0.01, "summary_gap_pp": 1e-4, "failure_gap_pp": 1e-6},
    "tiny-search": {"text_cos_gap": 2e-4, "score_gap": 2e-2, "topk_gap": 2e-2},
}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """The toy benchmark tree under ``tmp``; ``limits`` overrides LIMITS by mix."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": n, "source": "https://example.org", "file": f"perfbench/configs/{n}.json",
                        "reduced": [], "why": "toy"} for n in CONFIGS]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "toy"} for n, c, t in CELLS]
    for kind, entries in HELD_OUT_METRICS.items():
        have = {m["name"] for m in spec[kind]}
        spec[kind] += [dict(m) for m in entries if m["name"] not in have]
    by_mix = {"tiny-encode": ("qps", "encode"), "tiny-stats": ("bootstrap_iter_per_s", "stats"),
              "tiny-search": ("search_p95_ms", "search")}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            suffix = m["name"].rsplit(".", 1)[-1]
            m["workloads"] = [n for n, _, t in CELLS if m["name"] == by_mix[t][0] or suffix == by_mix[t][1]]
    root = Path(tmp)
    bench = root / "perfbench"
    for sub in ("drivers", "metrics"):
        shutil.copytree(REPO / sub, bench / sub)
    for sub, files in (("configs", {n: f() for n, f in CONFIGS.items()}), ("traffic", TRAFFIC)):
        (bench / sub).mkdir(parents=True)
        for name, body in files.items():
            (bench / sub / f"{name}.json").write_text(json.dumps(body))
    (bench / "limits").mkdir()
    lim = {**LIMITS, **(limits or {})}
    for name, _, mix in CELLS:
        (bench / "limits" / f"{name}.json").write_text(json.dumps({k: {"limit": v} for k, v in lim[mix].items()}))
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
