"""The ``late_hybrid`` driver's toy cell for the CPU tests: the
``colpali-granite-4.0-h-small`` configuration at width 64 (3 Mamba-2 layers
of 16 heads of 8, state 16, chunk 8, and one attention layer of 4 heads and 2
KV heads; 8 experts of 32 at top-2 and a shared one of 48) in f32, 28 px
pages, beside the toy tree of ``perfbench/tests/tiny.py``."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests.tiny import REPO, make_root

CELL = "tiny-granite.tiny-maxsim-hybrid"
# Limits at the toy size on the CPU in f32, about ten times what the port
# reads against the reference there (tests/test_torch_granite.py reads both).
# The two run the same f32 equations in other orders, but the port reads the
# pages from the device cache's preprocess and the reference preprocesses the
# raw image itself, a level of a pixel apart: that sets the score gap at about
# 1e-3 and the cosine gap at about 3e-6; no expert choice differs.
LIMITS = {"score_rel_gap": 1e-2, "route_flip_share": 2e-2, "route_margin": 1e-3, "token_cos_gap": 3e-5}


def config() -> dict:
    cfg = json.loads((REPO / "configs" / "colpali-granite-4.0-h-small.json").read_text())
    cfg.update(name="tiny-granite", dtype="float32", batch_size=2, vocab_size=512, hidden_size=64,
               intermediate_size=32, shared_intermediate_size=48, num_local_experts=8, num_experts_per_tok=2,
               num_attention_heads=4, num_key_value_heads=2, attention_multiplier=1 / 16, mamba_n_heads=16,
               mamba_d_head=8, mamba_d_state=16, mamba_chunk_size=8, num_hidden_layers=4,
               layer_types=["mamba", "attention", "mamba", "mamba"], embedding_dim=16)
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
                                image_size=28)
    cfg["preprocess"]["image_size"] = 28
    return cfg


TRAFFIC = {"driver": "late_hybrid", "images": 8, "caches": 2, "geometries": [[24, 32], [32, 24]],
           "captions_per_image": 5, "trace_units": 1, "check": {"rounds": 2, "pages": 2, "t2i_captions": 2,
                                                                 "captions": 4}}


def make_hybrid_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tiny.make_root``'s tree with the toy hybrid cell added."""
    root = make_root(tmp)
    bench = root / "perfbench"
    (bench / "configs" / "tiny-granite.json").write_text(json.dumps(config()))
    (bench / "traffic" / "tiny-maxsim-hybrid.json").write_text(json.dumps(TRAFFIC))
    lim = {**LIMITS, **(limits or {})}
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({k: {"limit": v} for k, v in lim.items()}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-granite", "source": "https://example.org",
                            "file": "perfbench/configs/tiny-granite.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": CELL, "config": "tiny-granite", "traffic": "tiny-maxsim-hybrid", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "qps" or m["name"].endswith(".late") or m["name"] in (
                "mfu_pct.encode", "device_idle_pct.encode", "attention_roofline_pct.encode",
                "preprocess_roofline_pct.encode"):
            m["workloads"] = [w for w in m["workloads"] if w.startswith("tiny")] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
