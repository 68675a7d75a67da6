"""Readings of a cell's compared numbers with a fault planted in the
program, to show which numbers of the check see it, in one process.

For each seed: a fault put in place of one of the program's functions
(``--fault none`` keeps the program as it is), the cell's set-up, a short
window at its own load, then the compared numbers of the program's outputs
and each against its limit, as ``calibrate.py`` reads them. Each line also
names the score behind ``score_rel_gap``: which matrix, the reference's
score and the program's, and the smallest and median magnitude of the
reference's scores in that matrix.

The faults are of the Mamba-2 scan that ``models/granite.py`` calls
(``ops/ssm.py:scan``), for the ``colpali-granite`` cell:

- ``scan_no_carry``: the state zeroed every 16 tokens (a stage of the
  kernel): the kernel run on each 16-token stretch on its own;
- ``scan_no_skip``: the kernel without the ``D`` skip;
- ``scan_bf16_decays``: each decay ``exp(dt A)`` rounded to bf16, in the
  chunked f32 form of ``ops/ssm.py:scan_plain`` over the rounded decays.

    python3 -m perfbench.faults --workload colpali-granite-4.0-h-small.coco-maxsim-hybrid \\
        --fault scan_no_carry --seeds 1001,1002 --seconds 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from multimodal_embedding_tpu_torch.models import granite
from multimodal_embedding_tpu_torch.ops import ssm

STAGE = 16  # the tokens the scan kernel stages at a time (csrc/ssm.cu: kSteps)
# scan_bf16_decays' chunk, whatever the model's: its f32 [chunk, chunk] blocks of
# a caption batch padded to 256 would take 4 GiB beside the 65 GB model
BF16_CHUNK = 32


def scan_no_carry(x, dt, A, B, C, D, *, chunk):
    """The scan with its state zeroed at the start of every stage."""
    return torch.cat([ssm.scan(x[:, s:s + STAGE], dt[:, s:s + STAGE].contiguous(), A, B[:, s:s + STAGE],
                               C[:, s:s + STAGE], D, chunk=STAGE) for s in range(0, x.shape[1], STAGE)], dim=1)


def scan_no_skip(x, dt, A, B, C, D, *, chunk):
    """The scan without the D skip."""
    return ssm.scan(x, dt, A, B, C, torch.zeros_like(D), chunk=chunk)


def scan_bf16_decays(x, dt, A, B, C, D, *, chunk):
    """The scan with each decay exp(dt A) rounded to bf16; the rest in f32,
    chunk by chunk as ``scan_plain`` runs it, in chunks of ``BF16_CHUNK``."""
    b, t, h, p = x.shape
    chunk = BF16_CHUNK
    pad = -t % chunk
    xf, dtf, bf, cf = (torch.nn.functional.pad(v.float(), (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, dt, B, C))
    nc = (t + pad) // chunk
    xc, dtc = xf.view(b, nc, chunk, h, p), dtf.view(b, nc, chunk, h)
    bc, cc = bf.view(b, nc, chunk, -1), cf.view(b, nc, chunk, -1)
    cum = torch.cumsum(torch.log(torch.exp(dtc * A.float()).bfloat16().float()), dim=2)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(~causal[:, :, None], -torch.inf)
    weight = torch.einsum("bcln,bcsn->bcls", cc, bc)[..., None] * torch.exp(seg) * dtc[:, :, None]
    y = torch.einsum("bclsh,bcshp->bclhp", weight, xc)
    own = torch.einsum("bclh,bclhp,bcln->bchpn", torch.exp(cum[:, :, -1:] - cum) * dtc, xc, bc)
    state = xf.new_zeros(b, h, p, bc.shape[-1])
    for c in range(nc):
        y[:, c] += torch.einsum("blh,bln,bhpn->blhp", torch.exp(cum[:, c]), cc[:, c], state)
        state = torch.exp(cum[:, c, -1])[:, :, None, None] * state + own[:, c]
    y = y.reshape(b, t + pad, h, p)[:, :t] + D.float()[:, None] * x.float()
    return y.to(x.dtype)


# each a stand-in for the scan that models/granite.py calls
FAULTS = {"scan_no_carry": scan_no_carry, "scan_no_skip": scan_no_skip, "scan_bf16_decays": scan_bf16_decays}


def worst_score(got: list[dict], want: list[dict]) -> dict:
    """The drawn score whose gap relative to the reference's is the largest."""
    best: dict = {"rel_gap": -1.0}
    for g, w in zip(got, want):
        for k in ("s_t2i", "s_i2t"):
            rel = ((g[k] - w[k]) / w[k]).abs()
            i = int(rel.argmax())
            if float(rel.flatten()[i]) > best["rel_gap"]:
                ref = w[k].abs().flatten()
                best = {"rel_gap": float(rel.flatten()[i]), "matrix": k, "reference": float(w[k].flatten()[i]),
                        "program": float(g[k].flatten()[i]), "matrix_min_abs": float(ref.min()),
                        "matrix_median_abs": float(ref.median())}
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=["none", *FAULTS])
    p.add_argument("--seeds", required=True, help="Comma-separated seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    from .harness import Bench, check, measure, verdict

    if not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 2
    if args.fault != "none":
        granite.scan = FAULTS[args.fault]
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
            seen["worst_score"] = worst_score(got, want)
            return compare(got, want)

        session.compare = noting
        numbers = check(session, records, cell)
        correct, compared = verdict(numbers, cell.limits)
        print(json.dumps({"seed": seed, "fault": args.fault, "units": len(records), "correct": correct,
                          "compared": compared, **seen, "seconds": time.perf_counter() - t0}), flush=True)
        del session, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, "-m", "perfbench.faults", *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
