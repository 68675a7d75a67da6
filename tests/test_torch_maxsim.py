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
The kernels' grid plans and tile walks are replayed in numpy, and the f32
kernel's 3xTF32 products (``tests/torch_tf32.py``) are held against the JAX
kernel in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tf32

import multimodal_embedding_tpu.ops.maxsim as jmaxsim
from multimodal_embedding_tpu_torch.ops import launch_counts, maxsim_cuda
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
    before = launch_counts()
    got = late_interaction_scores(q, d, qm, dm, impl=impl)
    assert launch_counts() == before
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


# --- the bf16 kernel's grid plan and index arithmetic --------------------------------

PLAN_SHAPES = [  # (NQ, TQ, ND, TD): ColPali T2I and I2T, the COCO-5k fifth, edges
    (128, 32, 128, 1030), (128, 1030, 640, 32), (1024, 1030, 5120, 32),
    (37, 45, 29, 75), (9, 32, 13, 1030), (5, 1030, 21, 32), (7, 33, 11, 65), (3, 130, 9, 7),
    (1, 1, 1, 1), (300, 5, 2, 3), (2, 128, 1, 129), (1, 64, 3, 8),
]


def _row_tiles(nrows):
    """The kernel's row tiles of a block's ``nrows`` flattened rows: per tile,
    (first row, rows) of each warpgroup (64 rows) that holds a real row."""
    for lr0 in range(0, nrows, 128):
        yield [(lr0 + w, min(64, nrows - lr0 - w)) for w in (0, 64) if lr0 + w < nrows]


@pytest.mark.parametrize("nq,tq,nd,td", PLAN_SHAPES)
def test_grid_plan_covers_every_pair_once(nq, tq, nd, td):
    plan = maxsim_cuda.plan_grid(nq, tq, nd, td)
    seen = np.zeros((nq, nd), int)
    for qs, ds in plan.blocks():
        assert 0 < len(qs) <= plan.qpb and 0 < len(ds) <= plan.dps
        seen[qs.start : qs.stop, ds.start : ds.stop] += 1
        rows = np.zeros(len(qs) * tq, int)  # every query row computed by one warpgroup once
        for tile in _row_tiles(len(qs) * tq):
            for r0, n in tile:
                rows[r0 : r0 + n] += 1
        assert (rows == 1).all()
    assert (seen == 1).all()
    # shared memory of the sums and accumulators, and the exact division by td8
    assert 4 * plan.dps * (128 + plan.qpb) <= maxsim_cuda._SUMS_BUDGET
    assert (plan.dps * plan.td8 + 128) * plan.td8 < 1 << 40


def test_grid_plan_fills_the_card_at_the_colpali_shapes():
    t2i = maxsim_cuda.plan_grid(128, 32, 128, 1030)
    i2t = maxsim_cuda.plan_grid(128, 1030, 640, 32)
    assert (t2i.qpb, t2i.nblocks) == (4, 128)  # 4 captions a row tile, one wave on 132 SMs
    assert i2t.qpb > 1 and i2t.nblocks % 132 > 120  # whole 1030-token image queries, near-whole waves
    tiles = list(_row_tiles(i2t.qpb * 1030))  # 1088 rows or fewer a query, not 1152
    assert len(tiles) * 128 <= 1088 * i2t.qpb


def _emulate_kernel(q, d, qm, dm, plan, bn=128, sim_fn=None):
    """numpy replay of the index arithmetic of csrc/maxsim.cu's kernels
    (wgmma_kernel: ring tiles of ``bn`` 128 tokens; tf32x3_kernel: 64): the
    packed doc tokens (td8 a doc, the division by td8 as a multiply), the
    running max per 8-column group with its flush at each doc's last group
    into per-(doc, row) values, and their per-(query, doc) sums over each row
    tile of 128 rows. The similarities come from ``sim_fn(rows, tokens)``,
    numpy in f64 by default."""
    nq, tq, _ = q.shape
    nd, td, _ = d.shape
    td8 = plan.td8
    inv = ((1 << 40) + td8 - 1) // td8
    out = np.zeros((nq, nd), np.float32)
    for qs, ds in plan.blocks():
        q0, d0, ndocs = qs.start, ds.start, len(ds)
        nrows, total = len(qs) * tq, ndocs * td8
        ncols = -(-total // bn) * bn
        pos = np.arange(ncols)
        doc = (pos * inv) >> 40
        s = pos - doc * td8
        valid = (pos < total) & (s < td)
        src = np.where(valid, (d0 + np.minimum(doc, ndocs - 1)) * td + np.minimum(s, td - 1), 0)
        valid &= dm.reshape(-1)[src]
        dtok = d.reshape(-1, d.shape[2])[src]
        accs = np.zeros((len(qs), ndocs), np.float32)
        for lr0 in range(0, nrows, 128):
            lr = lr0 + np.arange(128)
            ql = np.where(lr < nrows, lr // tq, -1)
            qrows = np.where((lr < nrows)[:, None], q[q0 + np.maximum(ql, 0), np.minimum(lr, nrows - 1) % tq], 0)
            w = np.where(lr < nrows, qm[q0 + np.maximum(ql, 0), np.minimum(lr, nrows - 1) % tq], 0).astype(np.float32)
            prod = qrows @ dtok.T if sim_fn is None else sim_fn(qrows, dtok)
            sim = np.where(valid[None, :], prod, -1e30).astype(np.float32)
            rv = np.zeros((ndocs, 128), np.float32)
            m = np.full(128, -1e30, np.float32)
            cur = 0

            def flush(cur, m):
                rv[cur] = w * m

            for t in range(ncols // bn):
                p = t * bn
                dcur = (p * inv) >> 40
                off = p - dcur * td8
                for g in range(bn // 8):
                    if p >= total:
                        break
                    if dcur != cur:
                        flush(cur, m)
                        cur, m = dcur, np.full(128, -1e30, np.float32)
                    m = np.maximum(m, sim[:, p : p + 8].max(1))
                    p, off = p + 8, off + 8
                    if off == td8:
                        off, dcur = 0, dcur + 1
            flush(cur, m)
            lr1 = min(lr0 + 128, nrows)
            for qq in range(lr0 // tq, (lr1 - 1) // tq + 1):
                lo, hi = max(qq * tq, lr0) - lr0, min((qq + 1) * tq, lr1) - lr0
                accs[qq] += rv[:, lo:hi].sum(1)
        out[q0 : q0 + len(qs), d0 : d0 + ndocs] = accs
    return out


@pytest.mark.parametrize("nq,tq,nd,td,masked,empty_doc", [
    (9, 32, 5, 260, False, False),  # T2I-like: 4 queries a row tile, docs crossing ring tiles
    (3, 150, 21, 32, False, False),  # I2T-like: a query over two row tiles, 4 docs a ring tile
    (7, 13, 9, 19, True, True),  # warps spanning 2 queries, TD not a multiple of 8, masks
    (4, 5, 40, 7, True, False),  # 16-row warps over 4 queries, 16 docs a ring tile
])
def test_bf16_kernel_index_arithmetic_matches_plain(nq, tq, nd, td, masked, empty_doc):
    (_, _, _, _), (q, d, qm, dm) = _problem(6, nq, tq, nd, td, 8, "float32", masked, empty_doc)
    want = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm).numpy()
    plan = maxsim_cuda.plan_grid(nq, tq, nd, td, sms=8)  # several slices and groups
    got = _emulate_kernel(q.numpy(), d.numpy(), qm.numpy(), dm.numpy(), plan)
    if empty_doc:
        np.testing.assert_allclose(got[:, nd // 2], want[:, nd // 2], rtol=1e-6)
        got, want = np.delete(got, nd // 2, 1), np.delete(want, nd // 2, 1)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


# --- the f32 kernel: its plan, its tile walk, its 3xTF32 products ---------------------

SEARCH_SHAPE = (64, 32, 5000, 1030)  # 64 queries of 32 tokens against a COCO-5k-sized ColPali index


@pytest.mark.parametrize("nq,tq,nd,td", PLAN_SHAPES + [SEARCH_SHAPE])
def test_f32_grid_plan_covers_every_pair_once(nq, tq, nd, td):
    plan = maxsim_cuda.plan_grid_f32(nq, tq, nd, td)
    seen = np.zeros((nq, nd), int)
    for qs, ds in plan.blocks():
        assert 0 < len(qs) <= plan.qpb and 0 < len(ds) <= plan.dps
        seen[qs.start : qs.stop, ds.start : ds.stop] += 1
    assert (seen == 1).all()
    assert 4 * plan.dps * (128 + plan.qpb) <= maxsim_cuda._F32_SUMS_BUDGET
    assert (plan.dps * plan.td8 + 64) * plan.td8 < 1 << 40
    assert plan.nblocks < 1 << 31  # a one-dimensional grid


def test_f32_grid_plan_fills_the_card_at_the_search_shape():
    plan = maxsim_cuda.plan_grid_f32(*SEARCH_SHAPE)
    assert plan.qpb == 4 and plan.nblocks % 132 == 0  # 4 queries a row tile, whole waves on 132 SMs


@pytest.mark.parametrize("nq,tq,nd,td,masked,empty_doc", [
    (9, 32, 5, 260, False, False),  # docs crossing 64-token ring tiles
    (2, 32, 6, 1030, False, False),  # search-like: a doc over 17 ring tiles, most inside one doc
    (3, 150, 21, 32, False, False),  # a query over two row tiles, 2 docs a ring tile
    (7, 13, 9, 19, True, True),  # TD not a multiple of 8, masks, a doc with no valid token
    (4, 5, 40, 7, True, False),  # 8 docs a ring tile
])
def test_f32_kernel_tile_walk_matches_plain(nq, tq, nd, td, masked, empty_doc):
    """csrc/maxsim.cu:tf32x3_kernel replayed: plan_grid_f32's blocks, 64-token
    ring tiles of packed docs, 8 group maxima a tile, the fixed-order sums,
    and the similarities as the kernel's 3xTF32 products."""
    (_, _, _, _), (q, d, qm, dm) = _problem(7, nq, tq, nd, td, 16, "float32", masked, empty_doc)
    want = maxsim_cuda.maxsim_scores_ref(q, d, qm, dm).numpy()
    plan = maxsim_cuda.plan_grid_f32(nq, tq, nd, td, sms=8)  # several slices and groups
    assert plan.nblocks > 1
    got = _emulate_kernel(q.numpy(), d.numpy(), qm.numpy(), dm.numpy(), plan, bn=64,
                          sim_fn=lambda a, b: torch_tf32.matmul(a.astype(np.float32), b.T, "kernel"))
    if empty_doc:
        np.testing.assert_allclose(got[:, nd // 2], want[:, nd // 2], rtol=1e-6)
        got, want = np.delete(got, nd // 2, 1), np.delete(want, nd // 2, 1)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("rounding", ["rne", "kernel"])
@pytest.mark.parametrize("nq,tq,nd,td,masked", [(4, 32, 16, 100, True), (3, 45, 7, 75, False)])
def test_3xtf32_emulation_holds_jax_kernel(rounding, nq, tq, nd, td, masked):
    """The f32 kernel's products, 3xTF32 emulated in numpy (round to nearest
    even, and the kernel's own rounding), hold the JAX Pallas kernel in f32
    within max|d|/max|want| 3e-6, a margin under the card's 1e-5 gate, at D
    128 on unit-norm token embeddings (ColPali's); one TF32 pass does not
    hold 1e-5."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((nq, tq, 128), dtype=np.float32)
    d = rng.standard_normal((nd, td, 128), dtype=np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    qm, dm = np.ones((nq, tq), np.float32), np.ones((nd, td), bool)
    if masked:
        qm = (rng.random((nq, tq)) > 0.2).astype(np.float32)
        dm = rng.random((nd, td)) > 0.25
        dm[:, 0] = True
    want = np.asarray(jmaxsim._maxsim_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d), jnp.asarray(dm),
                                             block_q=4, block_d=4, token_tile=8, interpret=True))

    def rel(passes):
        got = torch_tf32.maxsim(q, d, qm, dm, rounding=rounding, passes=passes)
        return float(np.abs(got - want).max() / np.abs(want).max())

    assert rel(3) <= 3e-6
    assert rel(1) > 1e-5
