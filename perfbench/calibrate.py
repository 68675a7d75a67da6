"""Readings for the limits of a cell's compared numbers, in one process.

For each seed: the cell's set-up, a short window at its own load, then the
compared numbers of the program's outputs; for the first ``--control``
seeds also those of the control, the reference in the precision below the
cell's put in the program's place ("fp8" for a bfloat16 model, "tf32" for
the float32 statistics). One JSON line a reading, then, a number, the lower
reading (the largest the program gives) and the upper (the smallest the
control gives).

    python3 -m perfbench.calibrate --workload clip-l.coco-encode --seeds 1,2,3 --control 3 --seconds 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="Comma-separated seeds")
    p.add_argument("--control", type=int, default=3, help="How many of the seeds also read the control")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    import torch

    from .harness import Bench, check, measure

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    control = bench.driver(bench.cell(args.workload, 0, "cpu", False)).CONTROL
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = bench.cell(args.workload, seed, "cuda", False)
        session = bench.driver(cell).Session(cell)
        session.warmup()
        records = measure(session, cell, args.seconds)[0]
        session.free()
        kinds = [("program", None)] + ([("control", control)] if n < args.control else [])
        for kind, prec in kinds:
            numbers = check(session, records, cell, prec)
            for k, v in numbers.items():
                book = lower if kind == "program" else upper
                book[k] = max(book.get(k, v), v) if kind == "program" else min(book.get(k, v), v)
            print(json.dumps({"seed": seed, "kind": kind, "units": len(records), "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
        del session, records
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "control": control, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, "-m", "perfbench.calibrate", *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
