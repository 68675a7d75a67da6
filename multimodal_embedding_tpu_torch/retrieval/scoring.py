"""Similarity scoring (reference main.py:440-475, v28:390-391).

Counterpart of ``multimodal_embedding_tpu/retrieval/scoring.py``. Dense
models: one f32 cosine matmul (embeddings are already L2-normalized).
Multi-vector models (ColPali): MaxSim late interaction through the
hand-written kernel (``ops/maxsim_cuda.py``). Scores are [n_queries, n_docs]
(the v28 orientation). With a ``mesh`` whose data axis is above 1 the query
rows are sharded over it (padded to a multiple), each data rank scores its
block against every doc, and the blocks are gathered in order.
"""

from __future__ import annotations

import torch

from ..ops.maxsim_cuda import maxsim_scores
from ..parallel.batched import sharded_batch_apply


def dense_scores(queries: torch.Tensor, docs: torch.Tensor, mesh=None) -> torch.Tensor:
    """[NQ, E] x [ND, E] -> [NQ, ND] float32 similarity."""
    df = docs.float()
    if mesh is None or mesh.n_data == 1:
        return torch.matmul(queries.float(), df.T)
    return sharded_batch_apply(lambda q: torch.matmul(q.float(), df.T), queries, mesh=mesh,
                               batch_size=queries.shape[0])


def late_interaction_scores(
    q: torch.Tensor,
    d: torch.Tensor,
    q_mask: torch.Tensor | None = None,
    d_mask: torch.Tensor | None = None,
    *,
    impl: str = "auto",
    mesh=None,
) -> torch.Tensor:
    """Multi-vector MaxSim scores [NQ, ND] float32. impl (``--maxsim-impl``):
    "auto" and "pallas" take the kernel for CUDA tensors, "xla" the plain
    version; CPU tensors always take the plain version."""
    return maxsim_scores(q, d, q_mask, d_mask, impl=impl, mesh=mesh)
