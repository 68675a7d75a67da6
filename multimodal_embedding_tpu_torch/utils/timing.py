"""Device-accurate timing.

The reference times its encode phase with wall clocks around CUDA work plus
``torch.cuda.synchronize`` (main.py:534-546). :func:`hard_sync` is that
barrier: every timer read on the encode path follows it, so QPS measures
device completion, not launch overhead. :func:`cuda_time_ms` times a
function on the card with CUDA events.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable

import torch


def hard_sync(x: Any) -> Any:
    """Wait for all work queued on the device holding ``x`` (a tensor or a
    tuple/list/dict of them); returns ``x``. A no-op for CPU tensors."""
    leaves = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else [x]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return x


def cuda_time_ms(fn: Callable[[], Any], iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream, each call
    timed by its own pair of CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
