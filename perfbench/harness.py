"""The harness: find a cell's files by name, set it up, measure a window,
check the outputs against the reference, and build the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<name>.py``). A driver's ``Session(cell)`` loads the weights and
inputs; ``warmup()`` runs the cell's own shapes once; ``step(i)`` runs one
unit of the window (a round or a request) and returns its record;
``required(records)`` gives the work those records need (``yardstick.py``);
``free()`` drops the program's state; ``sample``, ``outputs``, ``reference``
and ``compare`` make the check. A driver whose units leave outputs on the
device keeps only those of the units the check may draw (``Reservoir``), so
what the window holds stays flat. Every metric is read by
``metrics/<name>.py``'s ``read(run)``, which returns None where it finds
nothing to read. Each compared number's limit is in ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_embedding_tpu")


def sub_seed(seed: int, tag: int) -> int:
    """A seed for one use (weights, images, a round) drawn from the run's."""
    return (seed * 1_000_003 + tag) % (1 << 63)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """A RuntimeError, naming them, where such modules are loaded."""
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")


class Reservoir:
    """``size`` of the window's units, each unit as likely as any other to be
    kept, drawn from ``rng`` as the units come (Algorithm R): a kept unit's
    item replaces one kept before, so the items held never pass ``size``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0
        self.slots: list[tuple[int, object]] = []

    def offer(self, unit: int, item) -> None:
        j = self.seen if self.seen < self.size else int(self.rng.integers(self.seen + 1))
        self.seen += 1
        if j < len(self.slots):
            self.slots[j] = (unit, item)
        elif j < self.size:
            self.slots.append((unit, item))

    def kept(self) -> dict[int, object]:
        """{unit: item}, in the order of the units."""
        return dict(sorted(self.slots, key=lambda s: s[0]))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    trace: bool
    chips: int = 1
    limits: dict = field(default_factory=dict)
    spans: dict | None = None  # the engine's sweep spans, traced runs only


def _load_module(path: Path, kind: str):
    name = "perfbench_" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files of ``root/perfbench``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "perfbench"
        self._modules: dict[Path, object] = {}

    def _module(self, path: Path, kind: str):
        if path not in self._modules:
            self._modules[path] = _load_module(path, kind)
        return self._modules[path]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {[w['name'] for w in self.spec['workloads']]}")

    def cell(self, name: str, seed: int, device, trace: bool) -> Cell:
        w = self.workload(name)
        config = json.loads((self.dir / "configs" / f"{w['config']}.json").read_text())
        traffic = json.loads((self.dir / "traffic" / f"{w['traffic']}.json").read_text())
        limits_path = self.dir / "limits" / f"{name}.json"
        limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
        return Cell(name, config, traffic, seed, torch.device(device), trace, w["chips"], limits,
                    {} if trace else None)

    def driver(self, cell: Cell):
        return self._module(self.dir / "drivers" / f"{cell.traffic['driver']}.py", "driver")

    def metric(self, name: str):
        return self._module(self.dir / "metrics" / f"{name}.py", "metric")

    def metric_names(self, workload: str, trace: bool) -> list[str]:
        """The end-to-end metrics (``trace`` false) or per-layer metrics this
        cell reports: those that list it, or list no cells (a per-layer one
        then where its ``moves`` metric is reported)."""
        e2e = [m["name"] for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        return [m["name"] for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    session: object
    setup_s: float
    records: list[dict]  # the window's units, in order
    window_s: float  # from the window's start to the end of its last unit
    profiled: list[dict]  # the units under the profiler (traced runs)
    trace: object | None  # trace.Trace of the profiled stretch
    peaks: dict | None


def measure(session, cell: Cell, seconds: float) -> tuple[list[dict], float, list[dict], object | None]:
    """Back-to-back units for ``seconds``; in a traced run the profiler
    covers ``trace_units`` units after the first, the window running on
    until they are done."""
    from .trace import TRACED, Trace

    first, n_traced = 1, int(cell.traffic.get("trace_units", 2)) if cell.trace else 0
    records: list[dict] = []
    prof = span = None
    t0 = time.perf_counter()
    i = 0
    while True:
        if cell.trace and i == first:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            span = torch.profiler.record_function(TRACED)
            span.__enter__()
        rec = session.step(i)
        rec["t_end"] = time.perf_counter() - t0
        records.append(rec)
        i += 1
        if prof is not None and i == first + n_traced:
            span.__exit__(None, None, None)
            prof.stop()
        if rec["t_end"] >= seconds and i >= first + n_traced:
            break
    trace = Trace(prof.profiler.kineto_results.events()) if prof is not None else None
    return records, records[-1]["t_end"], records[first : first + n_traced], trace


def check(session, records: list[dict], cell: Cell, control: str | None = None) -> dict[str, float]:
    """The compared numbers: the program's outputs (or, for ``control``, the
    reference in that precision put in their place) against the reference
    on a sample drawn from the seed."""
    sample = session.sample(records, np.random.default_rng([cell.seed, 99]))
    got = session.reference(sample, control) if control else session.outputs(records, sample)
    return session.compare(got, session.reference(sample, "f32"))


def verdict(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and within
    its limit, and every limited number compared (keys starting with "_"
    annotate the limits file)."""
    shown = {n: {"value": v, "limit": limits.get(n, {}).get("limit")} for n, v in numbers.items()}
    limited = {n for n in limits if not n.startswith("_")}
    ok = bool(limited) and limited <= set(numbers)
    for n, row in shown.items():
        ok = ok and row["limit"] is not None and math.isfinite(row["value"]) and row["value"] <= row["limit"]
    return ok, shown


def run(bench: Bench, cell: Cell, seconds: float, t_start: float, *, device_name: str) -> dict:
    """Set up, warm up, measure, check; the result line's fields, or a
    RuntimeError where a forbidden module is loaded once all of that is done."""
    from .yardstick import peaks_for

    session = bench.driver(cell).Session(cell)
    session.warmup()
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    setup_s = time.perf_counter() - t_start
    records, window_s, profiled, trace = measure(session, cell, seconds)
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    r = Run(cell, session, setup_s, records, window_s, profiled, trace, peaks_for(device_name))
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench.spec["end_to_end"] + bench.spec["per_layer"]}
    for name in bench.metric_names(cell.name, cell.trace):
        value = bench.metric(name).read(r)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    session.free()
    correct, compared = verdict(check(session, records, cell), cell.limits)
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type, "kind": device_name,
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(records), "failed": 0, "metrics": metrics, "device": device}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["compared"] = compared
    refuse_forbidden()
    return line


def describe(compared: dict) -> list[str]:
    """One line a compared number: its name, value and limit."""
    return [f"compared {n}: {row['value']!r} limit {row['limit']!r}" for n, row in compared.items()]
