"""Logging setup mirroring the reference benchmark's observability contract.

The reference (main.py:53-68, :740-752) logs to both a file and stdout and
silences noisy third-party libraries; we preserve that behavior so log-driven
workflows port over unchanged.
"""

from __future__ import annotations

import logging
import os
import sys

_NOISY = ("transformers", "datasets", "PIL", "torch", "urllib3", "filelock", "fsspec")


def setup_logging(log_file: str | None = "benchmark_v29.log", level: int = logging.INFO) -> logging.Logger:
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
    for name in _NOISY:
        logging.getLogger(name).setLevel(logging.ERROR)
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    os.environ.setdefault("TRANSFORMERS_VERBOSITY", "error")
    return logging.getLogger("mme_tpu")
