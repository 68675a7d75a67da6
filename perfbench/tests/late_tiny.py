"""The ``late`` driver's toy cell for the CPU tests: the
``colpali-kimi-vl-a3b`` configuration at width 64 (one dense layer, then 2
MoE layers of 8 experts, top-2, 2 shared), 28 px pages, beside the toy tree
of ``tiny.py``."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests.tiny import REPO, make_root

CELL = "tiny-kimi.tiny-maxsim"
# Limits at the toy size on the CPU, about ten times what the bf16 port reads
# against the f32 reference there (test_perfbench_late.py reads both)
LIMITS = {"score_rel_gap": 0.03, "route_flip_share": 0.05, "route_margin": 3e-3, "token_cos_gap": 1e-3}


def config() -> dict:
    cfg = json.loads((REPO / "configs" / "colpali-kimi-vl-a3b.json").read_text())
    cfg.update(name="tiny-kimi", vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8, num_experts_per_tok=2,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rope_theta=10000.0,
               embedding_dim=16, batch_size=2)
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
                                image_size=28)
    cfg["preprocess"]["image_size"] = 28
    return cfg


TRAFFIC = {"driver": "late", "images": 8, "caches": 2, "geometries": [[24, 32], [32, 24]], "captions_per_image": 5,
           "trace_units": 1, "check": {"rounds": 2, "pages": 2, "t2i_captions": 2, "captions": 4}}


def make_late_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tiny.make_root``'s tree with the toy late cell added."""
    root = make_root(tmp)
    bench = root / "perfbench"
    (bench / "configs" / "tiny-kimi.json").write_text(json.dumps(config()))
    (bench / "traffic" / "tiny-maxsim.json").write_text(json.dumps(TRAFFIC))
    lim = {**LIMITS, **(limits or {})}
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({k: {"limit": v} for k, v in lim.items()}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-kimi", "source": "https://example.org",
                            "file": "perfbench/configs/tiny-kimi.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": CELL, "config": "tiny-kimi", "traffic": "tiny-maxsim", "chips": 1, "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "qps" or m["name"].endswith(".late") or m["name"] in (
                "mfu_pct.encode", "device_idle_pct.encode", "attention_roofline_pct.encode",
                "preprocess_roofline_pct.encode"):
            m["workloads"] = [w for w in m["workloads"] if w.startswith("tiny")] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
