"""Arithmetic the metric readers share. A reader returns None where its run
has nothing for it: no trace, no peaks for the card, no device time of its
kernels. It never returns 0 for a share of a peak or of a roofline."""

from __future__ import annotations

import statistics

from .yardstick import bound_s


def idle_pct(run) -> float | None:
    """Share of the traced stretch in which nothing ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run) -> float | None:
    """The profiled units' required operations over the traced stretch's
    seconds in the profiler's trace and the card's bf16 peak."""
    if run.trace is None or run.peaks is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.session.required(run.profiled)["flops"] / (run.trace.window_s * run.peaks["bf16_flops"])


def roofline_pct(run, kernels: tuple[str, ...], work: list[tuple[float, float]]) -> float | None:
    """The least seconds ``work`` [(operations, bytes), ...] allows over the
    device seconds of ``kernels`` in the traced stretch."""
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.kernel_seconds(kernels)
    if seconds <= 0:
        return None
    return 100.0 * sum(bound_s(f, b, run.peaks) for f, b in work) / seconds


def span_ms(run, name: str) -> float | None:
    """Median milliseconds of a unit's ``name`` span over the traced run."""
    values = [r["spans"][name] for r in run.records if name in r.get("spans", {})]
    return 1e3 * statistics.median(values) if values else None
