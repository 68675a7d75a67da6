"""The MoE layer's SwiGLU and weighted combine (``ops/moe.py``,
``ops/moe_cuda.py``) on the CPU.

On CPU tensors ``swiglu`` and ``combine`` are the plain versions. SwiGLU must
equal the inline line the DeepSeek decoder ran before the kernel existed, and
the combine, which now gathers each token's rows through ``Routing.rows``,
the composition it ran before, the permutation back by ``index_put``: both
bit for bit, with and without the shared experts' addend. ``Routing.rows``
must be the inverse of the stable sort of the choices by expert. The kernel wrappers' checks that
come before any launch (dtype, contiguity, alignment, width, the number of
choices, the device), their launch counts and their profiler spans run here
with the kernel call replaced; the kernels themselves are held to the plain
versions on the card (``tests/test_torch_moe_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from multimodal_embedding_tpu_torch import ops
from multimodal_embedding_tpu_torch.models.decoder import swiglu_mlp
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from multimodal_embedding_tpu_torch.ops import moe_cuda
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = (torch.float32, torch.bfloat16)


def _routing(n: int, k: int, e: int = 8, d: int = 16, seed: int = 0) -> tmoe.Routing:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen)
    return tmoe.route(x, torch.randn(e, d, generator=gen), torch.randn(e, generator=gen) * 0.1, top_k=k,
                      scale=2.446, normalize=True)


def _order(r: tmoe.Routing) -> torch.Tensor:
    """Each sorted row's place among the unsorted (token * k + choice): the
    stable sort of the choices by expert, made apart from ``route``."""
    return r.experts.reshape(-1).sort(stable=True).indices


def _index_put_combine(y: torch.Tensor, r: tmoe.Routing, shared: torch.Tensor | None) -> torch.Tensor:
    """The combine before ``Routing.rows``: the rows put back in token order,
    weighted and summed in f32, rounded, then the shared output added."""
    n, k = r.weights.shape
    unsorted = torch.empty_like(y)
    unsorted[_order(r)] = y
    out = (unsorted.view(n, k, -1).float() * r.weights[..., None]).sum(dim=1).to(y.dtype)
    return out if shared is None else out + shared


@pytest.mark.parametrize("n, k", [(1, 1), (5, 2), (37, 6), (200, 8)])
def test_rows_invert_the_sort(n, k):
    r = _routing(n, k, seed=n)
    flat, order = torch.arange(n * k), _order(r)
    assert r.rows.shape == (n, k) and r.rows.dtype == torch.int64 and r.rows.is_contiguous()
    assert torch.equal(r.rows.reshape(-1)[order], flat)  # the sorted row of each unsorted place
    assert torch.equal(order[r.rows.reshape(-1)], flat)
    assert torch.equal(r.token[r.rows], torch.arange(n)[:, None].expand(n, k))  # each row is its token's
    experts_sorted = r.experts.reshape(-1)[order]
    assert torch.equal(experts_sorted[r.rows], r.experts)  # and its choice's expert


@pytest.mark.parametrize("with_shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n, k", [(1, 1), (9, 2), (61, 6)])
def test_combine_through_rows_is_the_index_put_composition(n, k, dtype, with_shared):
    gen = torch.Generator().manual_seed(100 * n + k)
    r = _routing(n, k, seed=n + k)
    y = (torch.randn(n * k, 24, generator=gen) * 3).to(dtype)
    shared = (torch.randn(n, 24, generator=gen) * 3).to(dtype) if with_shared else None
    got = tmoe.combine(y, r, shared)
    want = _index_put_combine(y, r, shared)
    assert got.dtype == dtype and got.shape == (n, 24)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(7, 32), (2, 5, 48), (0, 16)])
def test_swiglu_is_the_inline_line(shape, dtype):
    gen = torch.Generator().manual_seed(len(shape))
    h = (torch.randn(*shape, generator=gen) * 4).to(dtype)
    g, u = h.float().chunk(2, dim=-1)
    want = (F.silu(g) * u).to(dtype)
    got = tmoe.swiglu(h)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_swiglu_mlp_is_unchanged(dtype):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(3, 5, 16, generator=gen).to(dtype)
    gate_up, down = torch.randn(16, 48, generator=gen).to(dtype), torch.randn(24, 16, generator=gen).to(dtype)
    g, u = (x @ gate_up).float().chunk(2, dim=-1)
    want = (F.silu(g) * u).to(dtype) @ down
    assert torch.equal(swiglu_mlp(x, gate_up, down), want)


def test_launch_counts_list_the_moe_kernels():
    for key in ("moe_swiglu", "moe_combine"):
        assert key in ops.LAUNCH_KEYS and key in ops.launch_counts()


def _combine_args(**change):
    """y [12, 16], rows and weights [4, 3] and shared [4, 16], bf16, as the
    kernel takes them; ``change`` replaces one."""
    r = _routing(4, 3)
    args = {"y": torch.zeros(12, 16, dtype=torch.bfloat16), "rows": r.rows, "weights": r.weights,
            "shared": torch.zeros(4, 16, dtype=torch.bfloat16)}
    args.update(change)
    return args


SWIGLU_REFUSED = {
    "dtype": (torch.zeros(4, 32, dtype=torch.float16), TypeError, "float32 or bfloat16"),
    "float64": (torch.zeros(4, 32, dtype=torch.float64), TypeError, "float32 or bfloat16"),
    "non-contiguous": (torch.zeros(32, 4, dtype=torch.bfloat16).t(), ValueError, "contiguous"),
    "misaligned": (torch.zeros(129, dtype=torch.bfloat16)[1:].view(4, 32), ValueError, "16-byte aligned"),
    "odd width": (torch.zeros(4, 33, dtype=torch.bfloat16), ValueError, "twice a multiple of 8"),
    "width off the vector": (torch.zeros(4, 36, dtype=torch.bfloat16), ValueError, "twice a multiple of 8"),
    "f32 width off the vector": (torch.zeros(4, 12), ValueError, "twice a multiple of 4"),
}


@pytest.mark.parametrize("case", SWIGLU_REFUSED)
def test_swiglu_wrapper_rejects_before_launch(case):
    h, err, match = SWIGLU_REFUSED[case]
    with pytest.raises(err, match=match):
        moe_cuda._run_swiglu(h)


COMBINE_REFUSED = {
    "dtype": (dict(y=torch.zeros(12, 16, dtype=torch.float16)), TypeError, "float32 or bfloat16"),
    "non-contiguous": (dict(y=torch.zeros(16, 12, dtype=torch.bfloat16).t()), ValueError, "contiguous"),
    "misaligned": (dict(y=torch.zeros(193, dtype=torch.bfloat16)[1:].view(12, 16)), ValueError, "16-byte aligned"),
    "odd width": (dict(y=torch.zeros(12, 12, dtype=torch.bfloat16), shared=None), ValueError, "multiple of 8"),
    "too many choices": (dict(rows=torch.zeros(1, 17, dtype=torch.int64), weights=torch.zeros(1, 17), shared=None),
                         ValueError, "1 to 16"),
    "rows dtype": (dict(rows=torch.zeros(4, 3, dtype=torch.int32)), TypeError, "rows int64"),
    "weights dtype": (dict(weights=torch.zeros(4, 3, dtype=torch.bfloat16)), TypeError, "weights float32"),
    "non-contiguous rows": (dict(rows=torch.zeros(3, 4, dtype=torch.int64).t()), ValueError, "contiguous rows"),
    "shared dtype": (dict(shared=torch.zeros(4, 16)), ValueError, "shared"),
    "shared shape": (dict(shared=torch.zeros(5, 16, dtype=torch.bfloat16)), ValueError, "shared"),
    "misaligned shared": (dict(shared=torch.zeros(65, dtype=torch.bfloat16)[1:].view(4, 16)), ValueError,
                          "16-byte aligned"),
}


@pytest.mark.parametrize("case", COMBINE_REFUSED)
def test_combine_wrapper_rejects_before_launch(case):
    change, err, match = COMBINE_REFUSED[case]
    with pytest.raises(err, match=match):
        moe_cuda._run_combine(**_combine_args(**change))


@pytest.mark.parametrize("op", ["swiglu", "combine"])
def test_wrappers_refuse_other_devices_and_gradients(op):
    def call(t):
        if op == "swiglu":
            return moe_cuda.swiglu(t)
        a = _combine_args()
        return moe_cuda.combine(t, a["rows"], a["weights"])

    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="cuda tensors"):
            call(torch.zeros(12, 16, dtype=torch.bfloat16, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        call(torch.zeros(12, 16, requires_grad=True))
    with torch.no_grad(), pytest.raises(ValueError, match="cuda tensors"):  # no gradient asked for
        call(torch.zeros(12, 16, requires_grad=True))
    meta = torch.zeros(12, 16, device="meta")  # the dispatcher sends no other device to the plain version
    with pytest.raises(ValueError, match="cuda tensors"):
        tmoe.swiglu(meta) if op == "swiglu" else tmoe.combine(meta, _routing(4, 3))


def _plain_swiglu(h):
    return tmoe.swiglu_plain(h)


def _plain_combine(y, rows, weights, shared):
    out = (y[rows].float() * weights[..., None]).sum(dim=1).to(y.dtype)
    return out if shared is None else out + shared


def test_launch_counts_and_spans(monkeypatch):
    """One count a launch, none for an empty tensor; the spans
    ``mme.kernel.moe_swiglu`` and ``mme.kernel.moe_combine`` while a
    profiler records."""
    monkeypatch.setattr(KERNELS, "counts", {})
    monkeypatch.setattr(moe_cuda, "_on_card", lambda *ts: None)
    monkeypatch.setattr(moe_cuda, "_run_swiglu", _plain_swiglu)
    monkeypatch.setattr(moe_cuda, "_run_combine", _plain_combine)
    a = _combine_args()
    h = torch.randn(3, 32).to(torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            moe_cuda.swiglu(h)
        for _ in range(2):
            moe_cuda.combine(a["y"], a["rows"], a["weights"], a["shared"])
    moe_cuda.swiglu(h[:0])
    counts = ops.launch_counts()
    assert counts["moe_swiglu"] == 3 and counts["moe_combine"] == 2
    names = [e.name for e in prof.events()]
    assert names.count("mme.kernel.moe_swiglu") == 3 and names.count("mme.kernel.moe_combine") == 2
