"""The port's scoring and statistics against the JAX package's, on the CPU.

``jax.random`` cannot be reproduced in PyTorch (COMPAT #6), so the port's
bootstrap and CI take index matrices; fed the same scores and the JAX
package's indices they must give exactly equal metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.retrieval import metrics as jmetrics
from multimodal_embedding_tpu.retrieval.scoring import dense_scores as jax_dense_scores
from multimodal_embedding_tpu.stats import bootstrap as jboot
from multimodal_embedding_tpu.stats.ci import bootstrap_confidence_interval as jax_ci
from multimodal_embedding_tpu_torch.retrieval import metrics as tmetrics
from multimodal_embedding_tpu_torch.retrieval.scoring import dense_scores
from multimodal_embedding_tpu_torch.stats import bootstrap as tboot
from multimodal_embedding_tpu_torch.stats.ci import bootstrap_confidence_interval


def _scores(n, kc, seed, quantize):
    """Score matrices from random unit embeddings; ``quantize`` rounds them to
    a coarse grid so that exact ties occur."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, 16)).astype(np.float32)
    txt = img.repeat(kc, axis=0) + 0.8 * rng.standard_normal((n * kc, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    s_t2i = txt[::kc] @ img.T
    s_i2t = img @ txt.T
    if quantize:
        s_t2i, s_i2t = np.round(s_t2i * 8) / 8, np.round(s_i2t * 8) / 8
    return s_t2i.astype(np.float32), s_i2t.astype(np.float32)


def test_dup_before_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, size=(5, 40))
    got = tboot._dup_before(torch.from_numpy(idx))
    for row, g in zip(idx, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jboot._dup_before(jnp.asarray(row))))


@pytest.mark.parametrize("n,kc,quantize", [(24, 5, False), (24, 5, True), (17, 1, True), (40, 3, False)])
def test_bootstrap_equals_jax_given_its_samples(n, kc, quantize):
    s_t2i, s_i2t = _scores(n, kc, seed=n + kc, quantize=quantize)
    want = jboot.bootstrap_benchmark(jnp.asarray(s_t2i), jnp.asarray(s_i2t), 30, seed=7, caps_per_image=kc)
    got = tboot.bootstrap_benchmark(torch.from_numpy(s_t2i), torch.from_numpy(s_i2t), 30, seed=7,
                                    caps_per_image=kc, sample_idx=want.sample_idx)
    assert list(got.metrics) == list(want.metrics)
    for name in want.metrics:
        np.testing.assert_array_equal(got.metrics[name], want.metrics[name], err_msg=name)
    np.testing.assert_array_equal(got.correct_r1, want.correct_r1)
    np.testing.assert_array_equal(got.sample_idx, want.sample_idx)


def test_bootstrap_draws_its_own_samples_from_the_seed():
    s_t2i, s_i2t = _scores(16, 5, seed=1, quantize=False)
    a = tboot.bootstrap_benchmark(torch.from_numpy(s_t2i), torch.from_numpy(s_i2t), 12, seed=3)
    b = tboot.bootstrap_benchmark(torch.from_numpy(s_t2i), torch.from_numpy(s_i2t), 12, seed=3)
    np.testing.assert_array_equal(a.sample_idx, b.sample_idx)
    assert a.sample_idx.shape == (12, 16) and a.sample_idx.dtype == np.int32
    # with the same samples, the port and the JAX package agree
    want = jboot.bootstrap_benchmark(jnp.asarray(s_t2i), jnp.asarray(s_i2t), 12, seed=3)
    c = tboot.bootstrap_benchmark(torch.from_numpy(s_t2i), torch.from_numpy(s_i2t), 12,
                                  sample_idx=want.sample_idx)
    for name in want.metrics:
        np.testing.assert_array_equal(c.metrics[name], want.metrics[name])


@pytest.mark.parametrize("n", [20, 200])
def test_confidence_interval_equals_jax_given_its_indices(n):
    rng = np.random.default_rng(n)
    data = (rng.integers(0, 33, n) * 100.0 / 32).astype(np.float32)
    idx = np.asarray(jax.random.randint(jax.random.key(0), (10_000, n), 0, n))
    assert bootstrap_confidence_interval(data, idx=idx) == jax_ci(data)


def test_dense_scores_and_ranks_match_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((12, 8)).astype(np.float32)
    d = rng.standard_normal((60, 8)).astype(np.float32)
    s = dense_scores(torch.from_numpy(q), torch.from_numpy(d))
    js = jax_dense_scores(jnp.asarray(q), jnp.asarray(d))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    sq = np.round(np.asarray(js) * 2) / 2  # coarse grid: index-order ties
    st = torch.from_numpy(sq)
    tgt = np.arange(12)
    np.testing.assert_array_equal(
        tmetrics.ranks_from_scores(st, torch.from_numpy(tgt)).numpy(),
        np.asarray(jmetrics.ranks_from_scores(jnp.asarray(sq), jnp.asarray(tgt))))
    cols = tgt[:, None] * 5 + np.arange(5)[None, :]
    np.testing.assert_array_equal(
        tmetrics.multi_target_ranks(st, torch.from_numpy(cols)).numpy(),
        np.asarray(jmetrics.multi_target_ranks(jnp.asarray(sq), jnp.asarray(cols))))
    sq_t2i = sq[:, :12]
    want = jmetrics.compute_metrics(jnp.asarray(sq_t2i), jnp.asarray(sq), jnp.asarray(sq_t2i.T))
    got = tmetrics.compute_metrics(torch.from_numpy(sq_t2i), st, torch.from_numpy(np.ascontiguousarray(sq_t2i.T)))
    assert got == want
