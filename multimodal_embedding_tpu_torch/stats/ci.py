"""Percentile bootstrap confidence intervals and permutation tests
(reference main.py:259-302).

Counterpart of ``multimodal_embedding_tpu/stats/ci.py``.
:func:`bootstrap_confidence_interval` takes 10,000 resamples of the
per-iteration metric values, then the mean and percentile bounds;
:func:`permutation_test` the share of 10,000 shuffles of the pooled values
whose |mean difference| reaches the observed one. ``jax.random`` cannot be
reproduced (COMPAT #6): pass ``idx`` to replay given resamples or
permutations, else they are drawn from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

_PERM_BATCH = 256  # shuffles drawn and scored at once


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


def permutation_test(
    data1: np.ndarray,
    data2: np.ndarray,
    n_permutations: int = 10_000,
    seed: int = 0,
    idx: np.ndarray | torch.Tensor | None = None,
    *,
    device,
) -> float:
    """Two-sided p-value for H0: same distribution, in f32 on ``device``.

    Each shuffle permutes the pooled values [data1, data2]; its statistic is
    |mean(first len(data1)) - mean(rest)|, and the p-value is the share of
    shuffles whose statistic is at least the observed |mean(data1) -
    mean(data2)|. The shuffles are argsorts of uniform draws from a
    ``torch.Generator`` seeded with ``seed``, 256 at a time; ``idx``
    [n_permutations, n] (each row a permutation of range(n)) replays given
    ones."""
    x1 = torch.as_tensor(np.asarray(data1), dtype=torch.float32).to(device)
    x2 = torch.as_tensor(np.asarray(data2), dtype=torch.float32).to(device)
    observed = (x1.mean() - x2.mean()).abs()
    combined = torch.cat([x1, x2])
    n1, n = x1.shape[0], combined.shape[0]
    if idx is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    else:
        idx = torch.from_numpy(np.array(idx, dtype=np.int64)).to(device)
        if tuple(idx.shape) != (n_permutations, n):
            raise ValueError(f"idx must be [{n_permutations}, {n}], got {tuple(idx.shape)}")
    hits = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(0, n_permutations, _PERM_BATCH):
        b = min(_PERM_BATCH, n_permutations - s)
        if idx is None:
            perm = torch.argsort(torch.rand((b, n), generator=gen, device=device), dim=1)
        else:
            perm = idx[s : s + b]
        shuffled = combined[perm]
        diffs = (shuffled[:, :n1].mean(dim=1) - shuffled[:, n1:].mean(dim=1)).abs()
        hits += (diffs >= observed).sum()
    return float(hits.float() / n_permutations)
