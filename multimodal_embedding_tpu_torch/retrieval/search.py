"""Retrieval search API: top-k queries against an embedding index.

Counterpart of ``multimodal_embedding_tpu/retrieval/search.py``. Load an
index written by ``cli/encode_cli.py`` (or build one in memory), encode
queries with the same model, and return the top-k documents: one f32 matmul
for a dense index, the MaxSim kernel (``ops/maxsim_cuda.py``) for a
multi-vector one. encode_cli writes f32, so a multi-vector index runs the
f32 kernel and its queries are cast to f32.

Ties break as ``jax.lax.top_k`` breaks them, the lower index first: the
order is a stable descending sort (``torch.topk`` on CUDA promises no order
among equal scores).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.maxsim_cuda import maxsim_scores


@dataclass
class Index:
    embeddings: torch.Tensor  # [N, E] or [N, T, D] (multi-vector)
    ids: np.ndarray  # [N] document ids
    multi_vector: bool = False

    @classmethod
    def from_npz(cls, path: str, field: str = "image_embeddings", ids_field: str = "imgids", *, device):
        with np.load(path) as data:
            emb = torch.from_numpy(data[field]).to(device)
            ids = np.asarray(data[ids_field])
        return cls(embeddings=emb, ids=ids, multi_vector=emb.dim() == 3)

    def search(self, queries: torch.Tensor, k: int = 10,
               query_mask: torch.Tensor | None = None) -> tuple[np.ndarray, np.ndarray]:
        """queries [Q, E] (or [Q, T, D] multi-vector) -> (ids [Q, k], scores
        [Q, k]), best first."""
        queries = queries.to(self.embeddings.device)
        if self.multi_vector:
            scores = maxsim_scores(queries.to(self.embeddings.dtype), self.embeddings, q_mask=query_mask)
        else:
            scores = torch.matmul(queries.float(), self.embeddings.float().T)
        k = min(k, scores.shape[1])
        top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        return self.ids[top_idx[:, :k].cpu().numpy()], top_scores[:, :k].cpu().numpy()


def search_texts(model, engine, index: Index, texts: list[str], k: int = 10) -> list[list[tuple]]:
    """Encode text queries with the model's engine and search the index.
    Returns per-query [(doc_id, score), ...]."""
    res = engine.encode_texts(texts)
    ids, scores = index.search(res.embeddings, k=k, query_mask=res.mask)
    return [[(ids[q, j], float(scores[q, j])) for j in range(ids.shape[1])] for q in range(len(texts))]
