"""Readings of the ``colpali-kimi-linear`` cell's compared numbers with a
fault planted in its KDA recurrence, in one process: ``faults.py``'s runs and
lines (a fault in place of the program's function, the cell's set-up, a short
window, the compared numbers against their limits and the worst score), with
these faults of the recurrence that ``models/kimi_linear.py`` calls
(``ops/kda.py:kda``):

- ``kda_no_carry``: the state zeroed at each 64-token chunk: the kernel run
  on each chunk on its own;
- ``kda_scalar_decay``: each head's log decay the mean over its 128 channels,
  so the decay is one scalar a head and token (the scalar gated delta rule);
- ``kda_beta_one``: beta fixed at 1;
- ``kda_bf16_decays``: each decay exp(g) rounded to bf16 (the kernel given
  the log of the rounded decay).

Each runs the kernel on card tensors (and the plain version on CPU ones).

    python3 -m perfbench.faults_kda --workload colpali-kimi-linear-48b-a3b.coco-maxsim-kda \\
        --fault kda_no_carry --seeds 1001,1002 --seconds 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from multimodal_embedding_tpu_torch.models import kimi_linear
from multimodal_embedding_tpu_torch.ops import kda as kda_ops

from . import faults

CHUNK = 64  # the chunk of kda_no_carry: a chunked form's chunk


def kda_no_carry(q, k, v, g, beta):
    """The recurrence with its state zeroed at the start of every chunk."""
    return torch.cat([kda_ops.kda(*(x[:, s : s + CHUNK] for x in (q, k, v)), g[:, s : s + CHUNK].contiguous(),
                                  beta[:, s : s + CHUNK].contiguous()) for s in range(0, q.shape[1], CHUNK)], dim=1)


def kda_scalar_decay(q, k, v, g, beta):
    """Each head's decay the mean of its channels' (the scalar gated delta rule)."""
    return kda_ops.kda(q, k, v, g.mean(-1, keepdim=True).expand_as(g).contiguous(), beta)


def kda_beta_one(q, k, v, g, beta):
    return kda_ops.kda(q, k, v, g, torch.ones_like(beta))


def kda_bf16_decays(q, k, v, g, beta):
    """Each decay exp(g) rounded to bf16."""
    return kda_ops.kda(q, k, v, torch.log(torch.exp(g).bfloat16().float()), beta)


# each a stand-in for the recurrence that models/kimi_linear.py calls
FAULTS = {"kda_no_carry": kda_no_carry, "kda_scalar_decay": kda_scalar_decay, "kda_beta_one": kda_beta_one,
          "kda_bf16_decays": kda_bf16_decays}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=["none", *FAULTS])
    p.add_argument("--seeds", required=True, help="Comma-separated seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    from .harness import Bench, check, measure, verdict

    if not torch.cuda.is_available():
        print("faults_kda: no CUDA device", file=sys.stderr)
        return 2
    if args.fault != "none":
        kimi_linear.kda = FAULTS[args.fault]
    bench = Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = bench.cell(args.workload, seed, "cuda", False)
        session = bench.driver(cell).Session(cell)
        session.warmup()
        records = measure(session, cell, args.seconds)[0]
        session.free()
        compare, seen = session.compare, {}

        def noting(got, want):
            seen["worst_score"] = faults.worst_score(got, want)
            return compare(got, want)

        session.compare = noting
        correct, compared = verdict(check(session, records, cell), cell.limits)
        print(json.dumps({"seed": seed, "fault": args.fault, "units": len(records), "correct": correct,
                          "compared": compared, **seen, "seconds": time.perf_counter() - t0}), flush=True)
        del session, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, "-m", "perfbench.faults_kda", *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
