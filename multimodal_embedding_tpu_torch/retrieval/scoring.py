"""Similarity scoring (reference main.py:440-475, v28:390-391).

Counterpart of ``multimodal_embedding_tpu/retrieval/scoring.py`` for dense
models: one f32 cosine matmul (embeddings are already L2-normalized).
Scores are [n_queries, n_docs] (the v28 orientation).
"""

from __future__ import annotations

import torch


def dense_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """[NQ, E] x [ND, E] -> [NQ, ND] float32 similarity."""
    return torch.matmul(queries.float(), docs.float().T)
