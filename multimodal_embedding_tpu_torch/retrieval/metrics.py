"""Rank/recall metrics (reference main.py:305-383, v28:203-229).

Counterpart of ``multimodal_embedding_tpu/retrieval/metrics.py``. The rank of
the target among the gallery is

    rank = #(scores > target) + #(scores == target AND col < target_col)

which reproduces ``torch.topk``'s index-ordered tie-breaking: ``target in
topk(k)`` iff ``rank < k``. Multi-caption I2T takes the min over the targets.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_KS = (1, 5, 10)


def ranks_from_scores(scores: torch.Tensor, target_idx: torch.Tensor) -> torch.Tensor:
    """scores [NQ, ND] f32, target_idx [NQ] -> int32 ranks [NQ] (0-based)."""
    nd = scores.shape[1]
    tgt = scores.gather(1, target_idx[:, None])
    cols = torch.arange(nd, device=scores.device)[None, :]
    tie_before = (scores == tgt) & (cols < target_idx[:, None])
    return ((scores > tgt) | tie_before).sum(dim=1).to(torch.int32)


def multi_target_ranks(scores: torch.Tensor, target_cols: torch.Tensor) -> torch.Tensor:
    """Best (minimum) rank over the M target columns [NQ, M] of each query."""
    nd = scores.shape[1]
    tgt = scores.gather(1, target_cols)  # [NQ, M]
    cols = torch.arange(nd, device=scores.device)[None, :, None]
    s, t = scores[:, :, None], tgt[:, None, :]
    ranks = ((s > t) | ((s == t) & (cols < target_cols[:, None, :]))).sum(dim=1)
    return ranks.min(dim=1).values.to(torch.int32)


def recall_at_k(ranks: torch.Tensor, k: int) -> torch.Tensor:
    """Percentage of queries whose target rank < k (rounded as JAX's mean:
    the hit count times the f32 reciprocal of the count)."""
    inv_n = torch.tensor(np.float32(1.0 / ranks.shape[0]), device=ranks.device)
    return 100.0 * ((ranks < k).float().sum() * inv_n)


def mrr(ranks: torch.Tensor) -> torch.Tensor:
    """Mean reciprocal rank (the v15-v19 metric), in f32."""
    return torch.mean(1.0 / (1.0 + ranks.float()))


def compute_metrics(
    scores_t2i: torch.Tensor,
    scores_i2t: torch.Tensor,
    scores_i2t_sym: torch.Tensor | None = None,
    ks: tuple[int, ...] = DEFAULT_KS,
    include_mrr: bool = False,
    caps_per_image: int = 5,
) -> dict[str, float]:
    """Single-pass (non-bootstrap) metrics, v28 protocol: T2I query i targets
    image i; I2T image i targets captions K*i..K*i+K-1; symmetric I2T image i
    targets caption i."""
    n = scores_t2i.shape[0]
    diag = torch.arange(n, device=scores_t2i.device)
    out: dict[str, float] = {}
    r_t2i = ranks_from_scores(scores_t2i, diag)
    for k in ks:
        out[f"T2I_R@{k}"] = float(recall_at_k(r_t2i, min(k, scores_t2i.shape[1])))
    if include_mrr:
        out["T2I_MRR"] = float(mrr(r_t2i))
    groups = diag[:, None] * caps_per_image + torch.arange(caps_per_image, device=diag.device)[None, :]
    r_i2t = multi_target_ranks(scores_i2t, groups)
    for k in ks:
        out[f"I2T_R@{k}"] = float(recall_at_k(r_i2t, min(k, scores_i2t.shape[1])))
    if include_mrr:
        out["I2T_MRR"] = float(mrr(r_i2t))
    if scores_i2t_sym is not None:
        r_sym = ranks_from_scores(scores_i2t_sym, diag)
        for k in ks:
            out[f"I2T_Sym_R@{k}"] = float(recall_at_k(r_sym, min(k, scores_i2t_sym.shape[1])))
    return out
