"""CLI: statistical analysis report (reference analyze_statistical_results.py
CLI surface: --input --output --alpha).

Counterpart of ``multimodal_embedding_tpu/cli/analyze.py``; with a
``<input>.bootstrap.npz`` sidecar the permutation tests run on ``--device``
(default cuda; without a CUDA device it exits nonzero unless ``--device cpu``
was given).

    python -m multimodal_embedding_tpu_torch.cli.analyze --input results.csv --output report.md
"""

from __future__ import annotations

import argparse

import pandas as pd

from ..analysis.report import generate_report, load_bootstrap_sidecar
from .main import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Analyze V29 statistical results")
    p.add_argument("--input", type=str, required=True, help="Input CSV from V29 benchmark")
    p.add_argument("--output", type=str, default="statistical_analysis_report.md",
                   help="Output markdown report")
    p.add_argument("--alpha", type=float, default=0.05, help="Significance level (default 0.05)")
    p.add_argument("--plots", action="store_true",
                   help="Also emit PNGs next to the report: accuracy-vs-QPS "
                        "Pareto frontier + per-category accuracy heatmap (the "
                        "visualizations the reference docstring promises but "
                        "never implements, analyze_statistical_results.py:12)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Run the permutation tests on the CUDA card (default) or, only when asked, the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"Loading results from {args.input}...")
    df = pd.read_csv(args.input)
    bootstrap = load_bootstrap_sidecar(args.input)
    if bootstrap is not None:
        print("Found bootstrap sidecar — using real permutation tests.")
    print("Generating statistical analysis report...")
    generate_report(df, args.output, args.alpha, bootstrap=bootstrap, device=device)
    print(f"✅ Report saved to {args.output}")
    if args.plots:
        from ..analysis.plots import emit_plots

        for p in emit_plots(df, args.output):
            print(f"📈 Plot saved to {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
