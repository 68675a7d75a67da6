"""Bootstrap resampling on the device: the statistical engine.

Counterpart of ``multimodal_embedding_tpu/stats/bootstrap.py``, same
algorithm. For bootstrap sample ``idx`` (N draws with replacement), T2I
query r targets image idx[r] at the fixed diagonal score S[idx[r], idx[r]],
so comparison matrices are built once:

    C_t2i[a, b] = S_t2i[a, b] > S_t2i[a, a]      (image b outranks a's target)
    C_sym[a, b] = S_t2i[b, a] > S_t2i[a, a]      (caption b outranks, I2T-sym)
    G_t[a, c]   = S_i2t[a, c] > S_i2t[a, K*a+t]  (I2T, per own caption t)

and each iteration's ranks are matrix-vector products with the sample's
multiplicity vector ``m`` (bincount of idx), plus ``dup_before[r]``, the
earlier occurrences of idx[r] in the sample: torch.topk's index-order
tie-breaking among exact duplicates (COMPAT #4). Iterations run in chunks as
matrix products; the comparison matrices are f32 and every count is an exact
integer.

The JAX package draws samples with ``jax.random``, which PyTorch cannot
reproduce (COMPAT #6): pass ``sample_idx`` to replay given samples, else
they are drawn from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_KS = (1, 5, 10)
_ITER_CHUNK = 256


@dataclass
class BootstrapOutput:
    metrics: dict[str, np.ndarray]  # metric name -> [iterations] values (%)
    correct_r1: np.ndarray  # [iterations, N] bool, per-query T2I R@1
    sample_idx: np.ndarray  # [iterations, N] int32


def _dup_before(idx: torch.Tensor) -> torch.Tensor:
    """dup_before[..., r] = #{j < r : idx[..., j] == idx[..., r]} along the
    last dim, via one stable argsort."""
    n = idx.shape[-1]
    order = torch.argsort(idx, dim=-1, stable=True)
    sorted_idx = idx.gather(-1, order)
    pos = torch.arange(n, device=idx.device).expand_as(idx)
    is_start = torch.ones_like(idx, dtype=torch.bool)
    is_start[..., 1:] = sorted_idx[..., 1:] != sorted_idx[..., :-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    within = pos - group_start
    return torch.zeros_like(idx).scatter(-1, order, within)


def bootstrap_benchmark(
    scores_t2i: torch.Tensor,
    scores_i2t: torch.Tensor,
    n_iterations: int,
    seed: int = 42,
    ks: tuple[int, ...] = DEFAULT_KS,
    caps_per_image: int = 5,
    sample_idx: np.ndarray | torch.Tensor | None = None,
) -> BootstrapOutput:
    """scores_t2i [N, N] (rows = first-caption queries, cols = images, target
    on the diagonal); scores_i2t [N, K*N] (caption block K*i..K*i+K-1 belongs
    to image i). Runs on the scores' device. Returns per-iteration Recall@K
    for the three protocols (reference main.py:331-378)."""
    s_t = scores_t2i.float()
    s_i = scores_i2t.float()
    dev = s_t.device
    n = s_t.shape[0]
    kc = caps_per_image
    ar = torch.arange(n, device=dev)

    diag = torch.diagonal(s_t)
    c_t2i = (s_t > diag[:, None]).float()  # [N, N]
    c_sym = (s_t.T > diag[:, None]).float()
    own = s_i.gather(1, ar[:, None] * kc + torch.arange(kc, device=dev)[None, :])  # [N, K]
    # per own caption t: [N, K*N] 0/1 "caption c outranks caption t"
    g = [(s_i > own[:, t : t + 1]).float() for t in range(kc)]
    # tie bookkeeping among exact duplicates (see the JAX package)
    eq_own = own[:, :, None] == own[:, None, :]  # [N, K(t), K(s)]
    q_ties = eq_own.sum(dim=2).float()
    s_before_t = torch.arange(kc, device=dev)[None, :] < torch.arange(kc, device=dev)[:, None]
    e_lt = (eq_own & s_before_t[None]).sum(dim=2).float()

    if sample_idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        idx_all = torch.randint(0, n, (n_iterations, n), generator=gen, device=dev)
    else:
        idx_all = torch.from_numpy(np.array(sample_idx, dtype=np.int64)).to(dev)
        if tuple(idx_all.shape) != (n_iterations, n):
            raise ValueError(f"sample_idx must be [{n_iterations}, {n}], got {tuple(idx_all.shape)}")

    # percent of queries, rounded as the JAX package's compiled
    # 100 * mean(hits) is: the hit count times the folded f32 constant 100/N
    pct = torch.tensor(np.float32(np.float32(1.0 / n) * np.float32(100.0)), device=dev)
    mets, correct = [], []
    for s in range(0, n_iterations, _ITER_CHUNK):
        idx = idx_all[s : s + _ITER_CHUNK]  # [I, N]
        m = torch.zeros(idx.shape[0], n, device=dev).scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
        m_cap = m.repeat_interleave(kc, dim=1)  # caption multiplicities, block layout
        v_t2i = m @ c_t2i.T  # [I, N]
        v_sym = m @ c_sym.T
        dup = _dup_before(idx).float()
        rank_t2i = v_t2i.gather(1, idx) + dup
        rank_sym = v_sym.gather(1, idx) + dup
        # per threshold: strict-greater count + duplicate-block ties before
        # the target + earlier in-block ties; the best caption wins
        rank_i2t = torch.stack(
            [(m_cap @ g[t].T).gather(1, idx) + dup * q_ties[idx, t] + e_lt[idx, t] for t in range(kc)]
        ).amin(dim=0)
        cols = []
        for ranks, limit in ((rank_t2i, n), (rank_i2t, kc * n), (rank_sym, n)):
            for k in ks:
                cols.append((ranks < min(k, limit)).float().sum(dim=1) * pct)
        mets.append(torch.stack(cols, dim=1))
        correct.append(rank_t2i < 1)

    met_arr = np.clip(torch.cat(mets).cpu().numpy(), 0.0, 100.0)
    names = [f"T2I_R@{k}" for k in ks] + [f"I2T_R@{k}" for k in ks] + [f"I2T_Sym_R@{k}" for k in ks]
    return BootstrapOutput(
        metrics={name: met_arr[:, i] for i, name in enumerate(names)},
        correct_r1=torch.cat(correct).cpu().numpy(),
        sample_idx=idx_all.to(torch.int32).cpu().numpy(),
    )
