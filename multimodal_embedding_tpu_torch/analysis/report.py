"""Statistical report generator (reference analyze_statistical_results.py).

A copy of ``multimodal_embedding_tpu/analysis/report.py`` (host code) whose
permutation tests run in this package's ``stats/ci.py`` on ``device``; its
title and hardware line name PyTorch/CUDA.

Produces the same markdown report structure as the reference: ranked T2I /
I2T / symmetric-I2T tables with 95% CIs, a pairwise significance matrix
(***/**/*/ns), failure-analysis and per-category tables, an efficiency score
((accuracy/100) x QPS), conclusions and methodology notes.

Improvement over the reference: the reference can only approximate
significance via CI overlap + an effect-size normal CDF because it discards
the raw bootstrap samples (analyze_statistical_results.py:47-102, a
limitation it documents itself). Our benchmark CLI saves the per-iteration
bootstrap metric arrays to a ``<output>.bootstrap.npz`` sidecar, so when that
file is present the significance matrix uses REAL permutation tests
(reference main.py:281-302 semantics, run on device); it falls back to the
reference's CI-overlap approximation otherwise.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pandas as pd


def norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def format_ci(mean: float, lower: float, upper: float) -> str:
    return f"{mean:.1f}% [{lower:.1f}, {upper:.1f}]"


def load_bootstrap_sidecar(csv_path: str) -> dict[str, dict[str, np.ndarray]] | None:
    """{model: {metric: [iters] values}} from <csv>.bootstrap.npz, if present."""
    p = Path(str(csv_path) + ".bootstrap.npz")
    if not p.exists():
        return None
    data = np.load(p)
    out: dict[str, dict[str, np.ndarray]] = {}
    for key in data.files:
        model, metric = key.split("::", 1)
        out.setdefault(model, {})[metric] = data[key]
    return out


def ci_overlap_p_value(row_i: pd.Series, row_j: pd.Series, metric: str) -> float:
    """The reference's conservative approximation
    (analyze_statistical_results.py:47-102)."""
    overlap = not (
        row_i[f"{metric}_upper"] < row_j[f"{metric}_lower"]
        or row_j[f"{metric}_upper"] < row_i[f"{metric}_lower"]
    )
    if not overlap:
        return 0.01
    pooled = math.sqrt((row_i[f"{metric}_std"] ** 2 + row_j[f"{metric}_std"] ** 2) / 2)
    effect = abs(row_i[f"{metric}_mean"] - row_j[f"{metric}_mean"]) / pooled if pooled > 0 else 0.0
    return min(2 * (1 - norm_cdf(effect)), 1.0)


def pairwise_significance(
    df: pd.DataFrame, metric: str, bootstrap: dict | None, *, device
) -> tuple[pd.DataFrame, str]:
    """Returns (p-value matrix, method string)."""
    models = df["Model"].tolist()
    mat = np.ones((len(models), len(models)))
    method = "CI-overlap approximation (reference behavior)"
    use_perm = bootstrap is not None and all(
        m in bootstrap and metric in bootstrap[m] for m in models
    )
    if use_perm:
        from ..stats.ci import permutation_test

        method = "permutation test on raw bootstrap samples (10,000 shuffles)"
    for i, mi in enumerate(models):
        for j, mj in enumerate(models):
            if i == j:
                continue
            if use_perm:
                if j < i:
                    mat[i, j] = mat[j, i]
                else:
                    mat[i, j] = permutation_test(bootstrap[mi][metric], bootstrap[mj][metric], device=device)
            else:
                ri = df[df["Model"] == mi].iloc[0]
                rj = df[df["Model"] == mj].iloc[0]
                mat[i, j] = ci_overlap_p_value(ri, rj, metric)
    return pd.DataFrame(mat, index=models, columns=models), method


def _stars(p: float) -> str:
    if p < 0.001:
        return "***"
    if p < 0.01:
        return "**"
    if p < 0.05:
        return "*"
    return "ns"


def _ranked_table(df: pd.DataFrame, prefix: str, gap_vs: str | None = None) -> list[str]:
    cols = "| Rank | Model | R@1 | R@5 | R@10 |"
    sep = "|:----:|:------|:----|:----|:-----|"
    if gap_vs:
        cols = cols + " Gap vs T2I |"
        sep = sep + ":-----------|"
    lines = [cols, sep]
    medals = {1: "🥇 ", 2: "🥈 ", 3: "🥉 "}
    for rank, (_, row) in enumerate(df.iterrows(), 1):
        cells = [
            f"{medals.get(rank, '')}{rank}",
            f"**{row['Model']}**" if not gap_vs else str(row["Model"]),
        ]
        for k in (1, 5, 10):
            cells.append(
                format_ci(
                    row[f"{prefix}_R@{k}_mean"],
                    row[f"{prefix}_R@{k}_lower"],
                    row[f"{prefix}_R@{k}_upper"],
                )
            )
        if gap_vs:
            gap = row[f"{prefix}_R@1_mean"] - row[f"{gap_vs}_R@1_mean"]
            cells.append(f"{gap:+.1f}pp")
        lines.append("| " + " | ".join(cells) + " |")
    return lines


def generate_report(df: pd.DataFrame, output_path: str, alpha: float = 0.05,
                    bootstrap: dict | None = None, *, device) -> str:
    r: list[str] = []
    r += ["# Statistical Analysis Report - COCO Benchmark V29 (PyTorch/CUDA)", ""]
    r += ["## Executive Summary", ""]
    r += [
        "This report presents statistical analysis of multimodal embedding models with:",
        "- **Bootstrap confidence intervals** (1000+ iterations)",
        "- **Statistical significance testing** (pairwise comparisons)",
        "- **Failure analysis** (query complexity breakdown)",
        "- **Per-category performance** (COCO supercategories)",
        "",
    ]

    df_sorted = df.sort_values("T2I_R@1_mean", ascending=False)

    r += ["## Text-to-Image Retrieval (with 95% Confidence Intervals)", ""]
    r += _ranked_table(df_sorted, "T2I")
    r += [""]

    r += ["### Statistical Significance Testing (T2I R@1)", ""]
    sig, method = pairwise_significance(df_sorted, "T2I_R@1", bootstrap, device=device)
    r += [f"Pairwise comparisons ({method}):", ""]
    models = df_sorted["Model"].tolist()
    r.append("| Model | " + " | ".join(models) + " |")
    r.append("|:------|" + "|".join(["----:"] * len(models)) + "|")
    for mi in models:
        cells = [mi] + ["-" if mi == mj else _stars(sig.loc[mi, mj]) for mj in models]
        r.append("| " + " | ".join(cells) + " |")
    r += ["", "Legend: `***` p < 0.001, `**` p < 0.01, `*` p < 0.05, `ns` = not significant", ""]

    r += ["## Image-to-Text Retrieval", "", "### Standard Protocol (5 captions per image)", ""]
    r += _ranked_table(df.sort_values("I2T_R@1_mean", ascending=False), "I2T", gap_vs="T2I")
    r += ["", "### Symmetric Protocol (1 caption per image - directly comparable to T2I)", ""]
    r += _ranked_table(df.sort_values("I2T_Sym_R@1_mean", ascending=False), "I2T_Sym", gap_vs="T2I")
    r += [
        "",
        "**Key Observation:** Symmetric protocol eliminates multi-caption advantage,",
        "allowing direct comparison between T2I and I2T directions.",
        "",
    ]

    if "_failure_analysis" in df.columns:
        r += ["## Failure Analysis - Query Complexity Breakdown", "",
              "Performance by query complexity features:", ""]
        r.append(
            "| Model | Overall | Spatial | No Spatial | Color | No Color | Counting | No Counting |"
        )
        r.append("|:------|:-------:|:-------:|:----------:|:-----:|:--------:|:--------:|:-----------:|")
        fa_by_model = {}
        for _, row in df_sorted.iterrows():
            fa = row["_failure_analysis"]
            fa = json.loads(fa) if isinstance(fa, str) else fa
            fa_by_model[row["Model"]] = fa
            r.append(
                f"| {row['Model']} | {fa.get('overall_accuracy', 0):.1f}% | "
                f"{fa.get('accuracy_has_spatial', 0):.1f}% | {fa.get('accuracy_not_has_spatial', 0):.1f}% | "
                f"{fa.get('accuracy_has_color', 0):.1f}% | {fa.get('accuracy_not_has_color', 0):.1f}% | "
                f"{fa.get('accuracy_has_counting', 0):.1f}% | {fa.get('accuracy_not_has_counting', 0):.1f}% |"
            )
        r += [""]

        r += ["## Per-Category Performance (COCO Supercategories)", ""]
        all_cats = sorted(
            {c for fa in fa_by_model.values() for c in fa.get("accuracy_by_category", {})}
        )
        if all_cats:
            r.append("| Model | " + " | ".join(c.title() for c in all_cats) + " |")
            r.append("|:------|" + "|".join(["-----:"] * len(all_cats)) + "|")
            for model in models:
                cat_acc = fa_by_model.get(model, {}).get("accuracy_by_category", {})
                r.append(
                    "| " + " | ".join([model] + [f"{cat_acc.get(c, 0):.1f}%" for c in all_cats]) + " |"
                )
            r += [""]

    r += ["## Performance Metrics (Speed & Efficiency)", ""]
    r.append("| Model | QPS | Encoding Time | T2I R@1 | Efficiency Score |")
    r.append("|:------|:---:|:-------------:|:-------:|:----------------:|")
    for _, row in df_sorted.iterrows():
        qps = row.get("QPS", 0)
        eff = (row["T2I_R@1_mean"] / 100) * qps
        r.append(
            f"| {row['Model']} | {qps:.1f} | {row.get('Encoding_Time', 0):.1f}s | "
            f"{row['T2I_R@1_mean']:.1f}% | {eff:.1f} |"
        )
    r += ["", "**Efficiency Score** = (Accuracy / 100) × QPS (higher is better)", ""]

    r += ["## Key Conclusions", ""]
    best = df_sorted.iloc[0]
    r.append(
        f"1. **{best['Model']} achieves highest T2I R@1** at "
        f"{best['T2I_R@1_mean']:.1f}% [{best['T2I_R@1_lower']:.1f}, {best['T2I_R@1_upper']:.1f}]"
    )
    if len(df_sorted) > 1:
        second = df_sorted.iloc[1]
        p = sig.loc[best["Model"], second["Model"]]
        if p < alpha:
            r.append(f"   - This difference is **statistically significant** (p < {alpha})")
        else:
            r.append(
                f"   - Difference vs. {second['Model']} is **not statistically significant** (p = {p:.3f})"
            )
    r += [
        "",
        "2. **Bootstrap confidence intervals reveal true uncertainty**",
        "3. **Symmetric I2T protocol enables fair bidirectional comparison**",
        "4. **Query complexity analysis identifies model weaknesses**",
        "",
        "## Methodology Notes",
        "",
        "### Bootstrap Sampling",
        "- Each iteration resamples the image set WITH REPLACEMENT on device",
        "- Confidence intervals computed via percentile method (10,000 resamples)",
        "",
        "### Statistical Significance Testing",
        f"- {method}",
        "",
        "### Hardware",
        "- NVIDIA GPU (PyTorch/CUDA), bootstrap runs fully on device",
        "",
    ]

    text = "\n".join(r)
    with open(output_path, "w") as f:
        f.write(text)
    return text
