"""The port's MaxSim against the JAX package's, on the CPU.

The port's plain version (``ops/maxsim_cuda.py:maxsim_scores_ref``, which
CPU tensors always take) is held against the JAX Pallas kernel run in
interpret mode (as tests/test_maxsim.py runs it, with small blocks so that
every grid axis has several steps and ragged tails), against the JAX XLA
reference, and, for queries longer than 64 tokens, against the JAX wrapper's
query-token chunking. Inputs are made with numpy; masks and shapes that are
not multiples of any block; f32 and bf16 embeddings. Tolerance: max|d| at
most 1e-5 of max|want| (f32 sums in another order; bf16 products are exact
in f32). A doc with no valid token scores sums of -1e30 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_embedding_tpu.ops.maxsim as jmaxsim
from multimodal_embedding_tpu_torch.ops import maxsim_cuda
from multimodal_embedding_tpu_torch.retrieval.scoring import late_interaction_scores

REL_TOL = 1e-5


def _problem(seed, nq, tq, nd, td, dim, dtype, masked, empty_doc=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, tq, dim)).astype(np.float32)
    d = rng.standard_normal((nd, td, dim)).astype(np.float32)
    if dtype == "bfloat16":  # round once, then both packages see the same values
        q = np.array(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
        d = np.array(jnp.asarray(d).astype(jnp.bfloat16).astype(jnp.float32))
    qm = np.ones((nq, tq), np.float32)
    dm = np.ones((nd, td), bool)
    if masked:
        qm = (rng.random((nq, tq)) > 0.2).astype(np.float32)
        dm = rng.random((nd, td)) > 0.25
        dm[:, 0] = True
    if empty_doc:
        dm[nd // 2] = False
    jd, td_ = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jax_in = (jnp.asarray(q).astype(jd), jnp.asarray(d).astype(jd), jnp.asarray(qm), jnp.asarray(dm))
    torch_in = (torch.from_numpy(q).to(td_), torch.from_numpy(d).to(td_), torch.from_numpy(qm), torch.from_numpy(dm))
    return jax_in, torch_in


def _close(got: torch.Tensor, want, empty_col=None):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if empty_col is not None:
        np.testing.assert_allclose(got[:, empty_col], want[:, empty_col], rtol=1e-6)
        got, want = np.delete(got, empty_col, 1), np.delete(want, empty_col, 1)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,tq,nd,td,dim,masked,empty_doc", [
    (5, 7, 9, 33, 16, True, False),
    (3, 5, 6, 19, 8, False, False),
    (7, 13, 5, 41, 24, True, True),
    (1, 32, 11, 65, 128, False, False),
])
def test_plain_matches_jax_pallas_interpret(dtype, nq, tq, nd, td, dim, masked, empty_doc):
    (jq, jd, jqm, jdm), (q, d, qm, dm) = _problem(0, nq, tq, nd, td, dim, dtype, masked, empty_doc)
    want = jmaxsim._maxsim_pallas(jq, jqm, jd, jdm, block_q=4, block_d=4, token_tile=8, interpret=True)
    got = maxsim_cuda.maxsim_scores(q, d, qm, dm)
    _close(got, want, nd // 2 if empty_doc else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("doc_chunk", [1, 4, 128])
def test_plain_matches_jax_xla_reference(dtype, doc_chunk):
    (jq, jd, jqm, jdm), (q, d, qm, dm) = _problem(1, 6, 9, 10, 17, 16, dtype, True, True)
    want = jmaxsim.maxsim_scores_ref(jq, jd, jqm, jdm, doc_chunk=doc_chunk)
    got = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm, doc_chunk=doc_chunk)
    _close(got, want, 5)


def test_plain_without_masks_matches_jax():
    (jq, jd, _, _), (q, d, _, _) = _problem(2, 4, 11, 7, 9, 16, "float32", False)
    _close(maxsim_cuda.maxsim_scores(q, d), jmaxsim.maxsim_scores_ref(jq, jd))


def test_long_queries_match_jax_chunked_wrapper(monkeypatch):
    """Queries over 64 tokens (ColPali I2T: the image is the query): the JAX
    wrapper sums 64-token chunks of Pallas kernel calls, the port sums all
    tokens at once; only the order of the f32 sum differs."""
    (jq, jd, jqm, jdm), (q, d, qm, dm) = _problem(3, 3, 150, 5, 40, 16, "float32", True)
    orig = jmaxsim._maxsim_pallas

    def interpret(q, qm, d, dm, **kw):
        kw.update(block_q=4, block_d=4, token_tile=8, interpret=True)
        return orig(q, qm, d, dm, **kw)

    monkeypatch.setattr(jmaxsim, "_maxsim_pallas", interpret)
    want = jmaxsim.maxsim_scores(jq, jd, jqm, jdm, impl="pallas")
    _close(maxsim_cuda.maxsim_scores(q, d, qm, dm, impl="pallas"), want)


def test_plain_chunks_queries_without_changing_the_result(monkeypatch):
    (_, _, _, _), (q, d, qm, dm) = _problem(4, 9, 6, 7, 5, 8, "float32", True)
    whole = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm)
    monkeypatch.setattr(maxsim_cuda, "_PLAIN_BLOCK_ELEMS", 2 * 6 * 5)  # two queries per block
    chunked = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm, doc_chunk=3)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_cpu_tensors_take_the_plain_version(impl):
    (_, _, _, _), (q, d, qm, dm) = _problem(5, 3, 4, 5, 6, 8, "float32", True)
    before = maxsim_cuda.launches
    got = late_interaction_scores(q, d, qm, dm, impl=impl)
    assert maxsim_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(), maxsim_cuda.maxsim_scores_ref(q, d, qm, dm).numpy())


def test_impl_and_shapes_are_checked():
    q = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        maxsim_cuda.maxsim_scores(q, q, impl="flash")
    with pytest.raises(ValueError):
        maxsim_cuda.maxsim_scores(q, q, q_mask=torch.ones(2, 4))
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        maxsim_cuda.maxsim_cuda(q.to(torch.bfloat16), q.to(torch.bfloat16))


def test_jax_backend_is_the_cpu():
    assert jax.default_backend() == "cpu"
