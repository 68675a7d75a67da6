"""CLI: merge per-subset result CSVs into one table.

The reference ran model subsets on separate pods (torch-version split,
run_benchmark_v28_openai_apple.py; RESULTS_SUMMARY.md:100-103) and merged the
CSVs by hand into benchmark_v28_all_models_combined.csv. This makes the merge
a command: later files win on duplicate Model rows, column union preserved.
"""

from __future__ import annotations

import argparse

import pandas as pd


def merge_csvs(paths: list[str]) -> pd.DataFrame:
    frames = [pd.read_csv(p) for p in paths]
    merged = pd.concat(frames, ignore_index=True)
    merged = merged.drop_duplicates(subset=["Model"], keep="last").reset_index(drop=True)
    if "Weights" in merged.columns:
        # reference-schema CSVs (no provenance column, COMPAT.md #14) mix in
        # as explicit 'unknown' rather than NaN
        merged["Weights"] = merged["Weights"].fillna("unknown")
    return merged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Merge benchmark result CSVs")
    p.add_argument("inputs", nargs="+", help="Input CSVs (later files win on duplicates)")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    df = merge_csvs(args.inputs)
    df.to_csv(args.output, index=False)
    print(f"Merged {len(args.inputs)} files -> {args.output} ({len(df)} models)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
