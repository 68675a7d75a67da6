"""MaxSim late-interaction scoring: the hand-written Hopper kernel
(``csrc/maxsim.cu``) and its plain PyTorch version.

Counterpart of ``multimodal_embedding_tpu/ops/maxsim.py``:

    score[i, j] = sum_t q_mask[i, t] * max_{s : d_mask[j, s]} <q[i, t], d[j, s]>

over query-token embeddings q [NQ, TQ, D] and doc-token embeddings d [ND, TD, D]
(D = 128 for ColPali). Both versions accumulate every dot product in f32,
count a masked doc token as ``-1e30``, apply the query mask as an f32 weight
and sum over query tokens in f32; the result is f32 [NQ, ND].

:func:`maxsim_cuda` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it plans the kernel's grid (queries per
block, docs per slice) with :func:`plan_grid` for bf16 and
:func:`plan_grid_f32` for f32. The f32 kernel multiplies in 3xTF32 on the
tensor cores (within about 2^-21 of f32 a product); every search of an f32
index (``cli/search.py`` on ``cli/encode_cli.py``'s output) runs it.
:func:`maxsim_scores` routes by ``impl`` as :func:`route` resolves it
("auto"/"pallas": the kernel for CUDA tensors, "xla": the plain version);
tensors that lie on the CPU always take the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import runtime
from ..utils.profiling import KERNELS
from . import build

NEG_INF = -1e30
MAX_DIM = 128
IMPLS = ("auto", "pallas", "xla")
# Elements of one f32 similarity block [NQ chunk, doc chunk, TQ, TD] in the
# plain version (1 GiB): queries are chunked too so that long sweeps fit.
_PLAIN_BLOCK_ELEMS = 1 << 28

_c = ctypes
_ARGTYPES = [_c.c_int] + [_c.c_void_p] * 5 + [_c.c_int] * 5 + [_c.c_longlong] * 4 + [_c.c_int] * 2 + [_c.c_void_p]

# The bf16 kernel's tiles (csrc/maxsim.cu): 128 query rows a row tile; doc
# tokens in ring tiles of 128, each doc padded to a multiple of 8 tokens; a
# sweep pays about _FILL_TILES tiles to fill its ring.
_ROWS, _BN, _FILL_TILES = 128, 128, 3
# Shared memory a block may spend on its per-(doc, row) maxima and its
# accumulators, beside the 162 KB of query tile, ring and column bias.
_SUMS_BUDGET = 64 * 1024
# The f32 kernel's: 64-token ring tiles through 3 stages (2 tiles of fill),
# beside its 171 KB of f32 query tile, ring and column bias.
_F32_BN, _F32_FILL_TILES = 64, 2
_F32_SUMS_BUDGET = 56 * 1024


@dataclass(frozen=True)
class GridPlan:
    """A kernel's grid: block b owns queries [q0, q0 + qpb) of group
    b // nslices and docs [d0, d0 + dps) of slice b % nslices."""

    nq: int
    tq: int
    nd: int
    td: int
    qpb: int  # whole queries per block
    dps: int  # docs per slice

    @property
    def ngroups(self) -> int:
        return -(-self.nq // self.qpb)

    @property
    def nslices(self) -> int:
        return -(-self.nd // self.dps)

    @property
    def nblocks(self) -> int:
        return self.ngroups * self.nslices

    @property
    def td8(self) -> int:
        return -(-self.td // 8) * 8

    def blocks(self):
        """(queries range, docs range) of every block, in launch order."""
        for b in range(self.nblocks):
            g, s = divmod(b, self.nslices)
            q0, d0 = g * self.qpb, s * self.dps
            yield range(q0, min(q0 + self.qpb, self.nq)), range(d0, min(d0 + self.dps, self.nd))


@functools.lru_cache(maxsize=256)
def plan_grid(nq: int, tq: int, nd: int, td: int, sms: int = 132) -> GridPlan:
    """Choose queries per block and docs per slice for the bf16 kernel
    (128-token ring tiles, 4 stages; see :func:`_plan`). Cached: a call is a
    few thousand candidate plans."""
    return _plan(nq, tq, nd, td, sms, bn=_BN, fill=_FILL_TILES, budget=_SUMS_BUDGET)


@functools.lru_cache(maxsize=256)
def plan_grid_f32(nq: int, tq: int, nd: int, td: int, sms: int = 132) -> GridPlan:
    """The same search for the f32 kernel's tiles: 128-row query tiles,
    64-token ring tiles through 3 stages, its own shared-memory budget."""
    return _plan(nq, tq, nd, td, sms, bn=_F32_BN, fill=_F32_FILL_TILES, budget=_F32_SUMS_BUDGET)


def _plan(nq: int, tq: int, nd: int, td: int, sms: int, *, bn: int, fill: int, budget: int) -> GridPlan:
    """A block takes the whole queries that fit a 128-row tile; longer queries
    go 1, 2 or 4 to a block, their tokens flattened into 128-row tiles. The
    docs are cut into slices. Of these, the plan minimizes the estimated
    time: whole waves of blocks (one block an SM) times a block's ring tiles
    of ``bn`` tokens, each slice's packed tokens plus ``fill`` tiles of the
    ring's fill, for every row tile. Ties go to fewer queries per block, then
    fewer slices."""
    td8 = -(-td // 8) * 8
    best = None
    for qpb in [max(1, min(nq, _ROWS // tq))] if tq <= _ROWS else [q for q in (1, 2, 4) if q <= max(1, nq)]:
        nrt = -(-qpb * tq // _ROWS)
        ngroups = -(-nq // qpb)
        # the row maxima and accumulators in shared memory; positions
        # pos * td8 < 2^40 keep the kernel's division by td8 a multiply
        max_dps = min(nd, budget // (4 * (_ROWS + qpb)))
        while max_dps > 1 and (max_dps * td8 + bn) * td8 >= 1 << 40:
            max_dps //= 2
        if (max_dps * td8 + bn) * td8 >= 1 << 40:
            raise ValueError(f"maxsim kernel takes at most about 2^20 doc tokens, not {td}")
        s_min = -(-nd // max_dps)
        for s in range(s_min, max(s_min, min(nd, 8 * sms)) + 1):
            dps = -(-nd // s)
            blocks = ngroups * -(-nd // dps)
            cost = -(-blocks // sms) * nrt * (-(-dps * td8 // bn) + fill)
            if best is None or cost < best[0]:
                best = (cost, qpb, dps)
    _, qpb, dps = best
    return GridPlan(nq=nq, tq=tq, nd=nd, td=td, qpb=qpb, dps=dps)


def _masks(q, d, q_mask, d_mask):
    nq, tq, _ = q.shape
    nd, td, _ = d.shape
    if q_mask is None:
        q_mask = torch.ones(nq, tq, dtype=torch.float32, device=q.device)
    if d_mask is None:
        d_mask = torch.ones(nd, td, dtype=torch.bool, device=d.device)
    if tuple(q_mask.shape) != (nq, tq) or tuple(d_mask.shape) != (nd, td):
        raise ValueError(f"masks {tuple(q_mask.shape)}, {tuple(d_mask.shape)} for q {tuple(q.shape)}, "
                         f"d {tuple(d.shape)}")
    return q_mask, d_mask


def maxsim_scores_ref(q, d, q_mask=None, d_mask=None, doc_chunk: int = 128) -> torch.Tensor:
    """The plain version, a port of ``maxsim.py:maxsim_scores_ref``: f32
    einsum over doc chunks, ``-1e30`` for masked doc tokens, the max over doc
    tokens, then the q_mask-weighted sum over query tokens."""
    nq, tq, _ = q.shape
    nd, td, _ = d.shape
    q_mask, d_mask = _masks(q, d, q_mask, d_mask)
    qf, df = q.float(), d.float()
    qm, dm = q_mask.float(), d_mask.bool()
    doc_chunk = max(1, min(doc_chunk, nd))
    q_chunk = max(1, min(nq, _PLAIN_BLOCK_ELEMS // max(1, doc_chunk * tq * td)))
    out = torch.empty(nq, nd, dtype=torch.float32, device=q.device)
    for c0 in range(0, nd, doc_chunk):
        dc, dmc = df[c0 : c0 + doc_chunk], dm[c0 : c0 + doc_chunk]
        for i0 in range(0, nq, q_chunk):
            sim = torch.einsum("qtd,csd->qcts", qf[i0 : i0 + q_chunk], dc)
            sim = sim.masked_fill(~dmc[None, :, None, :], NEG_INF)
            tok_max = sim.amax(dim=-1)  # [q, c, TQ]
            out[i0 : i0 + q_chunk, c0 : c0 + doc_chunk] = torch.einsum(
                "qct,qt->qc", tok_max, qm[i0 : i0 + q_chunk])
    return out


def maxsim_cuda(q, d, q_mask=None, d_mask=None) -> torch.Tensor:
    """Launch the kernel: q [NQ, TQ, D], d [ND, TD, D] on the card (both
    bfloat16 or both float32, D a multiple of 8 up to 128); q_mask [NQ, TQ]
    (weights), d_mask [ND, TD] (nonzero = valid). Returns f32 [NQ, ND]."""
    with KERNELS.span("kernel.maxsim"):
        return _launch(q, d, q_mask, d_mask)


def _launch(q, d, q_mask, d_mask) -> torch.Tensor:
    if q.device.type != "cuda" or d.device != q.device:
        raise ValueError(f"maxsim kernel takes CUDA tensors on one device, not {q.device} and {d.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or d.dtype != q.dtype:
        raise TypeError(f"maxsim kernel takes bfloat16 or float32 embeddings of one dtype, not {q.dtype}, {d.dtype}")
    if q.dim() != 3 or d.dim() != 3 or d.shape[2] != q.shape[2]:
        raise ValueError(f"expected q [NQ, TQ, D] and d [ND, TD, D], got {tuple(q.shape)}, {tuple(d.shape)}")
    nq, tq, dim = q.shape
    nd, td, _ = d.shape
    if dim % 8 or dim > MAX_DIM:
        raise ValueError(f"maxsim kernel takes an embedding dim that is a multiple of 8 up to {MAX_DIM}, not {dim}")
    if td == 0:
        raise ValueError("maxsim kernel needs at least one doc token")
    out = torch.zeros(nq, nd, dtype=torch.float32, device=q.device)
    if nq == 0 or nd == 0 or tq == 0:
        return out  # an empty sum
    q, d = q.contiguous(), d.contiguous()
    qm = None if q_mask is None else q_mask.to(device=q.device, dtype=torch.float32).contiguous()
    dm = None if d_mask is None else d_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if (qm is not None and tuple(qm.shape) != (nq, tq)) or (dm is not None and tuple(dm.shape) != (nd, td)):
        raise ValueError(f"masks must be [NQ, TQ] = {(nq, tq)} and [ND, TD] = {(nd, td)}")
    if q.data_ptr() % 16 or d.data_ptr() % 16:
        raise ValueError("maxsim kernel needs 16-byte aligned embeddings")
    bf16 = q.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    g = (plan_grid if bf16 else plan_grid_f32)(nq, tq, nd, td, sms)
    fn = build.load("maxsim").maxsim_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        1 if bf16 else 0, q.data_ptr(), d.data_ptr(),
        None if qm is None else qm.data_ptr(), None if dm is None else dm.data_ptr(), out.data_ptr(),
        nq, tq, nd, td, dim, q.stride(0), q.stride(1), d.stride(0), d.stride(1), g.qpb, g.dps,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "maxsim kernel")
    KERNELS.count("maxsim" if bf16 else "maxsim_f32")
    return out


def route(impl: str, device) -> str:
    """The path ``impl`` takes for tensors on ``device``: "xla" on the CPU
    whatever ``impl`` says, else ``runtime.resolve``'s."""
    return "xla" if torch.device(device).type == "cpu" else runtime.resolve(impl, device)


def maxsim_scores(q, d, q_mask=None, d_mask=None, *, impl: str = "auto", mesh=None) -> torch.Tensor:
    """MaxSim scores [NQ, ND] (float32). impl: "auto" or "pallas" (the
    kernel; the name of the TPU package's kernel route) for CUDA tensors,
    "xla" the plain version; CPU tensors always take the plain version. With
    a ``mesh`` whose data axis is above 1, the query rows (and ``q_mask``)
    are padded to a multiple of it and each data rank scores its block
    against every doc (the kernel runs on that block); the blocks are
    gathered in order."""
    if impl not in IMPLS:
        raise ValueError(f"maxsim impl must be one of {IMPLS}, not {impl!r}")
    plain = route(impl, q.device) == "xla"

    def score(qb, qmb):
        return maxsim_scores_ref(qb, d, qmb, d_mask) if plain else maxsim_cuda(qb, d, qmb, d_mask)

    if mesh is None or mesh.n_data == 1:
        return score(q, q_mask)
    from ..parallel.batched import sharded_batch_apply

    return sharded_batch_apply(score, (q, q_mask), mesh=mesh, batch_size=q.shape[0])
