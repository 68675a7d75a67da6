"""Percentile bootstrap confidence intervals (reference main.py:259-278).

Counterpart of ``multimodal_embedding_tpu/stats/ci.py:
bootstrap_confidence_interval``: 10,000 resamples of the per-iteration
metric values, mean and percentile bounds. ``jax.random`` cannot be
reproduced (COMPAT #6): pass ``idx`` [n_bootstrap, n] to replay given
resamples, else they are drawn from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

import numpy as np
import torch


def bootstrap_confidence_interval(
    data: np.ndarray,
    confidence: float = 0.95,
    n_bootstrap: int = 10_000,
    seed: int = 0,
    idx: np.ndarray | torch.Tensor | None = None,
) -> tuple[float, float, float]:
    """Returns (mean, lower, upper), percentile method, in f32."""
    x = torch.as_tensor(np.asarray(data), dtype=torch.float32)
    n = x.shape[0]
    if idx is None:
        gen = torch.Generator().manual_seed(seed)
        idx = torch.randint(0, n, (n_bootstrap, n), generator=gen)
    else:
        idx = torch.from_numpy(np.array(idx, dtype=np.int64))
    means = x[idx].mean(dim=1)
    alpha = (1.0 - confidence) / 2.0
    q = torch.quantile(means, torch.tensor([alpha, 1.0 - alpha]))
    return float(x.mean()), float(q[0]), float(q[1])
