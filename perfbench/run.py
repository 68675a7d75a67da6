"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Stages: set-up (weights and inputs from the seed, made on the device; the
cell's own shapes run once), the measured window, the check against the
plain reference, the result line. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``compared``, each number
the check compared beside its limit); the last lines of standard error are
those numbers again. No result is printed, and the exit code is not 0,
without as many CUDA devices as the cell asks for, where a module of JAX or
of the JAX package has been loaded, or where anything fails.

The word tokenizer hashes with Python's ``hash``, which is salted per
process, so the run pins ``PYTHONHASHSEED`` (restarting itself once) and the
same seed gives the same token ids. The port's kernel builds stay in
``build/`` of this checkout (``ops/build.py``), and any Triton or extension
cache goes there too, at fixed paths.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "triton", "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}


def _pinned_env() -> dict | None:
    """The environment to restart in, or None where it is already set."""
    want = {"PYTHONHASHSEED": "0", **{k: str(v) for k, v in CACHE_DIRS.items()}}
    if all(os.environ.get(k) == v for k, v in want.items()):
        return None
    return {**os.environ, **want}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell of the port on the card")
    p.add_argument("--workload", required=True, help="A cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="Length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: profile a stretch of the window and report the per-layer metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from .harness import Bench, describe, refuse_forbidden, run

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    cell = bench.cell(args.workload, args.seed, "cuda", bool(args.trace))
    line = run(bench, cell, args.seconds, T_START, device_name=torch.cuda.get_device_name(0))
    text = json.dumps(line)
    refuse_forbidden()
    print("\n".join(describe(line["compared"])), file=sys.stderr)
    sys.stderr.flush()
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    env = _pinned_env()
    if env is not None:
        os.execve(sys.executable, [sys.executable, "-m", "perfbench.run", *sys.argv[1:]], env)
    sys.exit(main())
