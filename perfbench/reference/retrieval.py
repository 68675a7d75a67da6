"""Scoring, top-k and the bootstrap's recall, in plain PyTorch.

Recall follows the reference benchmark's protocol as the port states it
(COMPAT.md #4): bootstrap sample ``idx`` (N draws with replacement) forms
the sub-matrix of the sampled queries against the sampled candidates, in
sample order, and a query's rank is that of its target under
``torch.topk``'s index order among exact duplicates: the candidates that
score strictly higher, plus the copies of the target's own item (an image
sampled twice, or its own caption block) that score the same and come
earlier. Equal scores of distinct items are broken by strict comparison.
T2I: first captions against images. I2T: images against every caption of
the sample (K a sampled image, in block order), the best of the query's
own K captions. Symmetric I2T: images against the sampled first captions.
"""

from __future__ import annotations

import numpy as np
import torch

from .numerics import matmul, precision


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def dense_scores(queries: torch.Tensor, docs: torch.Tensor, prec: str) -> torch.Tensor:
    """[Q, E] x [D, E] -> [Q, D] cosine scores of normalized embeddings."""
    with precision(prec):
        return matmul(queries, docs.T, prec)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices, scores) of the k best of each row, the lower index first among equals."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return idx[:, :k], vals[:, :k]


def _ranks(sub: torch.Tensor, target_col: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """Rank of each row's target column: strictly higher scores, plus equal
    ones in earlier columns that hold the target's own item (``same``, [N, C]
    bool)."""
    rows = torch.arange(sub.shape[0], device=sub.device)
    target = sub[rows, target_col][:, None]
    earlier = torch.arange(sub.shape[1], device=sub.device)[None, :] < target_col[:, None]
    return (sub > target).sum(dim=1) + ((sub == target) & earlier & same).sum(dim=1)


def sample_ranks(s_t2i: torch.Tensor, s_i2t: torch.Tensor, idx: torch.Tensor,
                 k_caps: int) -> dict[str, torch.Tensor]:
    """One bootstrap sample's rank of each query's target, by protocol.
    s_t2i [N, N]: first-caption queries x images; s_i2t [N, K*N]: images x
    captions (image i's captions at K*i .. K*i + K - 1); idx [N] int64."""
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)
    same = idx[:, None] == idx[None, :]  # [N, N]: sample positions holding one item
    sub = s_t2i[idx][:, idx]  # [N queries, N images]
    rank_t2i = _ranks(sub, rows, same)
    rank_sym = _ranks(sub.T, rows, same)  # image queries against the sampled first captions
    cols = (idx[:, None] * k_caps + torch.arange(k_caps, device=idx.device)[None, :]).reshape(-1)
    sub_i2t = s_i2t[idx][:, cols]  # [N images, K*N captions]
    same_i2t = same.repeat_interleave(k_caps, dim=1)
    rank_i2t = torch.stack([_ranks(sub_i2t, rows * k_caps + t, same_i2t) for t in range(k_caps)]).amin(dim=0)
    return {"T2I": rank_t2i, "I2T": rank_i2t, "I2T_Sym": rank_sym}


def bootstrap_round(s_t2i: torch.Tensor, s_i2t: torch.Tensor, idx_all: torch.Tensor, k_caps: int,
                    ks: tuple[int, ...] = (1, 5, 10)) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Every iteration of a round, idx_all [I, N]: {metric: [I] recall (%)},
    and whether each sample position's T2I query found its image first,
    [I, N] bool."""
    metrics: dict[str, list[float]] = {}
    hits = []
    for idx in idx_all:
        ranks = sample_ranks(s_t2i, s_i2t, idx, k_caps)
        for name, r in ranks.items():
            for k in ks:
                metrics.setdefault(f"{name}_R@{k}", []).append(100.0 * int((r < k).sum()) / idx.shape[0])
        hits.append((ranks["T2I"] < 1).cpu())
    return {k: np.array(v) for k, v in metrics.items()}, torch.stack(hits).numpy()
