"""The harness finds every piece by name, and BENCHMARK.json keeps to the
contract's shape."""

from __future__ import annotations

import json
import re
import shutil

from perfbench.harness import ROOT, Bench, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
        assert len(w["why"]) <= 200
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in cells:  # every cell: set-up, another end-to-end metric, a per-layer one
        bench = Bench(ROOT)
        assert "setup_s" in bench.metric_names(w, False) and len(bench.metric_names(w, False)) >= 2
        assert bench.metric_names(w, True)


def test_new_files_are_found_by_name(tiny_root):
    """A configuration, a traffic mix, a per-layer metric and a cell added as
    files and entries alone run, the metric in the result line."""
    bench_dir = tiny_root / "perfbench"
    cfg = json.loads((bench_dir / "configs" / "tiny-clip.json").read_text())
    cfg["text_config"]["num_hidden_layers"] = 1
    (bench_dir / "configs" / "tiny-clip-1.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "tiny-search.json").read_text())
    mix["max_queries"] = 2
    (bench_dir / "traffic" / "tiny-search-2.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "queries_per_request.search.py").write_text(
        "def read(run):\n    return sum(r['queries'] for r in run.records) / len(run.records)\n")
    shutil.copy(bench_dir / "limits" / "tiny-clip.tiny-search.json", bench_dir / "limits" / "new.cell.json")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "new.cell", "config": "tiny-clip-1", "traffic": "tiny-search-2", "chips": 1,
                              "why": "toy"})
    spec["end_to_end"][[m["name"] for m in spec["end_to_end"]].index("search_p95_ms")]["workloads"].append("new.cell")
    spec["per_layer"].append({"name": "queries_per_request.search", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "traffic", "moves": "search_p95_ms",
                              "workloads": ["new.cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny_root)
    line = run(bench, bench.cell("new.cell", 5, "cpu", True), 0.3, 0.0, device_name="cpu")
    assert 1.0 <= line["metrics"]["queries_per_request.search"]["value"] <= 2.0
    line = run(bench, bench.cell("new.cell", 5, "cpu", False), 0.3, 0.0, device_name="cpu")
    assert set(line["metrics"]) == {"setup_s", "search_p95_ms"} and line["correct"]
