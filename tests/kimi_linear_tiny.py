"""The ``late_kda`` driver's toy cell for the CPU tests: the
``colpali-kimi-linear-48b-a3b`` configuration at width 64 (5 layers: KDA,
KDA, KDA, MLA, KDA; KDA 4 heads of 16; MLA 4 heads of 16 + 8, v 16, kv rank
32; the first layer a dense MLP of 96, then 8 experts of 32 at top-2 and one
shared) in f32, 28 px pages, beside the toy tree of
``perfbench/tests/tiny.py``."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests.tiny import REPO, make_root

CELL = "tiny-kimi-linear.tiny-maxsim-kda"
# Limits at the toy size on the CPU in f32, about ten times what the port
# reads against the reference there (tests/test_torch_kimi_linear.py reads
# both). The two run the same f32 equations in other orders (the chunked KDA
# against the token loop among them), but the port reads the pages from the
# device cache's preprocess and the reference preprocesses the raw image
# itself, a level of a pixel apart: that sets the score and cosine gaps; no
# expert choice differs.
LIMITS = {"score_rel_gap": 1e-2, "route_flip_share": 2e-2, "route_margin": 1e-3, "token_cos_gap": 3e-5}


def config() -> dict:
    cfg = json.loads((REPO / "configs" / "colpali-kimi-linear-48b-a3b.json").read_text())
    cfg.update(name="tiny-kimi-linear", dtype="float32", batch_size=2, vocab_size=512, hidden_size=64,
               intermediate_size=96, moe_intermediate_size=32, num_experts=8, num_experts_per_token=2,
               num_shared_experts=1, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, num_hidden_layers=5, embedding_dim=16)
    cfg["linear_attn_config"] = {"full_attn_layers": [4], "head_dim": 16, "kda_layers": [1, 2, 3, 5], "num_heads": 4,
                                 "short_conv_kernel_size": 4}
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
                                image_size=28)
    cfg["preprocess"]["image_size"] = 28
    return cfg


TRAFFIC = {"driver": "late_kda", "images": 8, "caches": 2, "geometries": [[24, 32], [32, 24]],
           "captions_per_image": 5, "trace_units": 1, "check": {"rounds": 2, "pages": 2, "t2i_captions": 2,
                                                                 "captions": 4}}


def make_kda_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tiny.make_root``'s tree with the toy KDA cell added."""
    root = make_root(tmp)
    bench = root / "perfbench"
    (bench / "configs" / "tiny-kimi-linear.json").write_text(json.dumps(config()))
    (bench / "traffic" / "tiny-maxsim-kda.json").write_text(json.dumps(TRAFFIC))
    lim = {**LIMITS, **(limits or {})}
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({k: {"limit": v} for k, v in lim.items()}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-kimi-linear", "source": "https://example.org",
                            "file": "perfbench/configs/tiny-kimi-linear.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": CELL, "config": "tiny-kimi-linear", "traffic": "tiny-maxsim-kda", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "qps" or m["name"].endswith(".late") or m["name"] in (
                "mfu_pct.encode", "device_idle_pct.encode", "attention_roofline_pct.encode",
                "preprocess_roofline_pct.encode"):
            m["workloads"] = [w for w in m["workloads"] if w.startswith("tiny")] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
