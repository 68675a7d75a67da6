"""Similarity scoring (reference main.py:440-475, v28:390-391).

Counterpart of ``multimodal_embedding_tpu/retrieval/scoring.py``. Dense
models: one f32 cosine matmul (embeddings are already L2-normalized).
Multi-vector models (ColPali): MaxSim late interaction through the
hand-written kernel (``ops/maxsim_cuda.py``). Scores are [n_queries, n_docs]
(the v28 orientation).
"""

from __future__ import annotations

import torch

from ..ops.maxsim_cuda import maxsim_scores


def dense_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """[NQ, E] x [ND, E] -> [NQ, ND] float32 similarity."""
    return torch.matmul(queries.float(), docs.float().T)


def late_interaction_scores(
    q: torch.Tensor,
    d: torch.Tensor,
    q_mask: torch.Tensor | None = None,
    d_mask: torch.Tensor | None = None,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-vector MaxSim scores [NQ, ND] float32. impl (``--maxsim-impl``):
    "auto" and "pallas" take the kernel for CUDA tensors, "xla" the plain
    version; CPU tensors always take the plain version."""
    return maxsim_scores(q, d, q_mask, d_mask, impl=impl)
