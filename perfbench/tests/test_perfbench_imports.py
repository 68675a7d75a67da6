"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from perfbench.harness import FORBIDDEN, ROOT

ALL = """
import sys
from perfbench import run, harness, calibrate, trace, readers
bench = harness.Bench()
for w in bench.spec["workloads"]:
    cell = bench.cell(w["name"], 0, "cpu", True)
    bench.driver(cell)
    for m in bench.metric_names(w["name"], True) + bench.metric_names(w["name"], False):
        bench.metric(m)
print(" ".join(harness.forbidden_modules()))
"""
REFERENCE = """
import sys
from perfbench.reference import numerics, preprocess, retrieval, statistics, tokenizer, towers
print(" ".join(sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0].startswith("multimodal")})))
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_no_jax_in_the_benchmark():
    assert _run(ALL) == ""


def test_forbidden_names_are_whole_top_level_names():
    import perfbench.harness as h

    assert "multimodal_embedding_tpu_torch" not in FORBIDDEN
    sys.modules["multimodal_embedding_tpu_fake"] = sys  # a longer name that only begins with one
    try:
        assert h.forbidden_modules() == [m for m in h.forbidden_modules() if m in FORBIDDEN]
        assert "multimodal_embedding_tpu_fake" not in h.forbidden_modules()
    finally:
        del sys.modules["multimodal_embedding_tpu_fake"]


def test_reference_imports_nothing_of_the_port():
    assert _run(REFERENCE) == ""
