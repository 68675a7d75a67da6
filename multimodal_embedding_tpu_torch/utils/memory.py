"""Device memory telemetry: the reference's ``torch.cuda.max_memory_allocated``
peak reporting (main.py:163-167)."""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("mme_tpu")


def device_memory_stats(device) -> dict:
    """Bytes in use, peak and total for a CUDA device; zeros on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def report_memory(device) -> float:
    """Log peak device memory in GB."""
    peak_gb = device_memory_stats(device)["peak_bytes_in_use"] / 1e9
    logger.info(f"    Device Memory Peak: {peak_gb:.2f} GB")
    return peak_gb
