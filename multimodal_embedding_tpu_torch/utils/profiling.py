"""Profiler integration: ``torch.profiler`` traces of the device.

Counterpart of ``multimodal_embedding_tpu/utils/profiling.py``. With a
directory, :func:`maybe_trace` records CPU and CUDA activity of the enclosed
region, writes a Chrome trace (view in Perfetto) and a text table of the
operators by device time, and logs the table's top rows; without one it is
a no-op. The CLI enables it with ``--profile-dir``.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import torch

logger = logging.getLogger("mme_tpu")


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, row_limit: int = 25):
    if not profile_dir:
        yield
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info(f"Capturing device trace to {out}")
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    table = prof.key_averages().table(sort_by=sort, row_limit=row_limit)
    (out / "ops.txt").write_text(table)
    logger.info(f"Trace written to {out} (trace.json, ops.txt); top operators by {sort}:\n{table}")
