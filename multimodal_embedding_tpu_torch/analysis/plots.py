"""Report visualizations the reference only advertised.

The reference analyzer's docstring promises "Pareto frontier plots" and
"performance heatmaps" (analyze_statistical_results.py:12) but implements
neither. Behind ``analyze --plots`` these exist: an accuracy-vs-QPS Pareto
scatter and a per-category accuracy heatmap from the failure-analysis JSON,
emitted as PNGs next to the markdown report.

Chart grammar: one axis per chart; the scatter is a single series with
direct text labels (identity is never color-alone); the heatmap is a
single-hue sequential ramp (magnitude) with in-cell value labels whose ink
flips for contrast; grids/axes are recessive grays; annotation text wears
neutral ink, never series color.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

_INK = "#1f2430"  # primary text
_MUTED = "#6a7184"  # secondary text / axes
_GRID = "#e3e6ee"
_POINT = "#2f6fe4"  # single-series accent
_FRONTIER = "#c2410c"


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_MUTED)
    ax.tick_params(colors=_MUTED, labelsize=9)
    ax.grid(True, color=_GRID, linewidth=0.8, zorder=0)
    ax.set_axisbelow(True)


def pareto_plot(
    df: pd.DataFrame, out_path: "Path | str", metric: str = "T2I_R@1_mean"
) -> Path:
    """Accuracy vs throughput scatter with the Pareto frontier (the models no
    other model beats on both axes). One series; identity via direct labels."""
    plt = _mpl()
    d = df.dropna(subset=[metric, "QPS"])
    x = d["QPS"].to_numpy(float)
    y = d[metric].to_numpy(float)
    names = d["Model"].tolist()

    # frontier: scan QPS descending, keep running-max accuracy
    order = np.argsort(-x)
    fx, fy = [], []
    best = -np.inf
    for i in order:
        if y[i] > best:
            best = y[i]
            fx.append(x[i])
            fy.append(y[i])

    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    _style(ax)
    ax.step(fx, fy, where="post", color=_FRONTIER, linewidth=2,
            zorder=2, label="Pareto frontier")
    ax.scatter(x, y, s=64, color=_POINT, zorder=3, edgecolors="white", linewidths=1.5)
    for xi, yi, name in zip(x, y, names):
        ax.annotate(
            name, (xi, yi), textcoords="offset points", xytext=(6, 6),
            fontsize=8, color=_INK,
        )
    ax.set_xlabel("QPS (images / encode second)", color=_INK, fontsize=10)
    ax.set_ylabel(metric.replace("_mean", " (%)"), color=_INK, fontsize=10)
    ax.set_title("Accuracy vs throughput — Pareto frontier", color=_INK, fontsize=11)
    ax.legend(frameon=False, fontsize=8, labelcolor=_INK)
    out_path = Path(out_path)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def category_heatmap(df: pd.DataFrame, out_path: "Path | str") -> Path | None:
    """Models x COCO-supercategories accuracy heatmap from the
    ``_failure_analysis`` JSON column. Sequential single-hue ramp; in-cell
    value labels flip ink for contrast. Returns None when the column or
    per-category data is absent."""
    if "_failure_analysis" not in df.columns:
        return None
    plt = _mpl()
    rows = []
    cats: list[str] = []
    for _, row in df.iterrows():
        fa = row["_failure_analysis"]
        fa = json.loads(fa) if isinstance(fa, str) else (fa or {})
        acc = fa.get("accuracy_by_category", {})
        rows.append((row["Model"], acc))
        for c in acc:
            if c not in cats:
                cats.append(c)
    cats.sort()
    if not cats:
        return None

    mat = np.full((len(rows), len(cats)), np.nan)
    for i, (_, acc) in enumerate(rows):
        for j, c in enumerate(cats):
            if c in acc:
                mat[i, j] = acc[c]

    fig, ax = plt.subplots(
        figsize=(1.1 + 0.75 * len(cats), 1.0 + 0.5 * len(rows)), dpi=150
    )
    im = ax.imshow(mat, cmap="Blues", vmin=0.0, vmax=100.0, aspect="auto")
    ax.set_xticks(range(len(cats)), cats, rotation=35, ha="right",
                  fontsize=8, color=_INK)
    ax.set_yticks(range(len(rows)), [m for m, _ in rows], fontsize=8, color=_INK)
    ax.tick_params(length=0)
    for spine in ax.spines.values():
        spine.set_visible(False)
    for i in range(len(rows)):
        for j in range(len(cats)):
            v = mat[i, j]
            if np.isnan(v):
                continue
            ax.text(
                j, i, f"{v:.0f}", ha="center", va="center", fontsize=7,
                color="white" if v > 60 else _INK,
            )
    fig.colorbar(im, ax=ax, shrink=0.85, label="R@1 accuracy (%)")
    ax.set_title("Per-category R@1 accuracy", color=_INK, fontsize=11)
    out_path = Path(out_path)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def emit_plots(df: pd.DataFrame, report_path: "Path | str") -> list[Path]:
    """Write the plot set next to the report; returns created paths."""
    base = Path(report_path)
    out = []
    p = pareto_plot(df, base.with_suffix(".pareto.png"))
    out.append(p)
    h = category_heatmap(df, base.with_suffix(".categories.png"))
    if h is not None:
        out.append(h)
    return out
