"""The routed experts of a mixture-of-experts layer: routing, a sort of the
routed rows by expert, one grouped product a projection, and the weighted
combine back to the tokens, all on the device with no host sync.

Two routers, one a model, each chosen by the layer that calls it:

- DeepSeek-V3's (:func:`route`, :func:`moe`; ``transformers``
  ``DeepseekV3TopkRouter`` and ``DeepseekV3MoE``), for one expert group
  (``n_group`` = ``topk_group`` = 1, as Kimi-VL-A3B publishes): logits
  ``x @ W^T`` in f32 (the hidden states and the router weight cast to f32),
  scores ``sigmoid(logits)``; the ``k`` experts of the largest ``score +
  bias`` (the correction bias decides the choice only); each chosen expert's
  weight its score, over the chosen scores' sum (+ 1e-20) where
  ``normalize``, times ``scale``;
- Granite-4.0-H's (:func:`route_softmax`, :func:`moe_softmax`;
  ``GraniteMoeHybridTopKGating``): logits ``x @ W^T`` in f32, the ``k``
  experts of the largest logits, no bias, their weights the softmax of the
  ``k`` chosen logits, no scale.

Then, for both, each expert a SwiGLU MLP, ``down(silu(gate x) * up x)``; the
token's output the weighted sum of its experts' outputs, accumulated in f32
and rounded once to the hidden dtype, then the shared experts' output added.

The routed rows (token, choice) are sorted by expert (stable, so a token's
rows keep their order within an expert), the experts' row ends found by a
binary search of the sorted ids (``torch.bincount`` reads its maximum back
on the card, a host sync), and each projection of every expert runs as one
grouped product over the sorted rows. On the card that is
``torch._grouped_mm`` on bf16, counted as ``grouped_mm`` in
``ops.launch_counts()``; on CPU tensors, and for any other dtype, the plain
version: one product an expert over its slice of rows.

SwiGLU between the two products and the weighted combine (with the shared
experts' output added) are one hand-written pass each on CUDA tensors
(``ops/moe_cuda.py``, ``csrc/moe.cu``: read in the hidden dtype, f32 math,
every rounding point of the plain versions kept); on CPU tensors their plain
versions, :func:`swiglu_plain` and :func:`combine_plain`, the f32 ATen
compositions. The combine reads each token's sorted rows through
``Routing.rows``, the inverse of the sort, made on the device by one scatter.

Expert weights keep the checkpoint's layout, ``[E, out, in]`` a projection
(gate and up stacked on ``out``), which the grouped product reads
transposed, column-major.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..utils.profiling import KERNELS, Tally
from . import moe_cuda


@dataclass
class Routing:
    """The routed rows of ``n`` tokens, sorted by expert."""

    experts: torch.Tensor  # [n, k] int64: each token's chosen experts
    token: torch.Tensor  # [n * k] int64: the token of each sorted row
    rows: torch.Tensor  # [n, k] int64: each (token, choice)'s sorted row
    ends: torch.Tensor  # [E] int32: the row after each expert's last (cumulative)
    counts: torch.Tensor  # [E] int64: each expert's rows
    weights: torch.Tensor  # [n, k] f32: each choice's combine weight


def _sorted(experts: torch.Tensor, weights: torch.Tensor, n_experts: int) -> Routing:
    """The routed rows of ``experts`` [n, k] sorted by expert."""
    top_k = experts.shape[1]
    # order: each sorted row's place among the unsorted (token * k + choice)
    flat_sorted, order = torch.sort(experts.reshape(-1), stable=True)
    ids = torch.arange(n_experts, device=experts.device, dtype=flat_sorted.dtype)
    ends = torch.searchsorted(flat_sorted, ids, right=True)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    rows = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=experts.device))
    return Routing(experts, order // top_k, rows.view(-1, top_k), ends.to(torch.int32), counts, weights)


def route(x: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor, *, top_k: int, scale: float,
          normalize: bool) -> Routing:
    """DeepSeek-V3's routing of tokens x [n, D] over the experts of
    ``w_router`` [E, D] with the correction ``bias`` [E]."""
    scores = torch.sigmoid(x.float() @ w_router.float().T)  # [n, E]
    experts = torch.topk(scores + bias.float(), top_k, dim=-1, sorted=False).indices
    weights = scores.gather(1, experts)
    if normalize:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return _sorted(experts, weights * scale, w_router.shape[0])


def route_softmax(x: torch.Tensor, w_router: torch.Tensor, *, top_k: int) -> Routing:
    """Granite-4.0-H's routing of tokens x [n, D] over the experts of
    ``w_router`` [E, D]: the top ``top_k`` f32 logits, weighted by their
    softmax."""
    top = torch.topk(x.float() @ w_router.float().T, top_k, dim=-1, sorted=False)
    return _sorted(top.indices, torch.softmax(top.values, dim=-1), w_router.shape[0])


def _grouped_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """One product an expert: rows ``[ends[e-1], ends[e])`` of x times
    ``w[e]^T``, in x's dtype."""
    out = x.new_empty(x.shape[0], w.shape[1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].T
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sorted rows x [M, K] through each expert's projection w [E, N, K]:
    [M, N] in x's dtype, rows of expert e at ``[ends[e-1], ends[e])``."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)
        KERNELS.count("grouped_mm")
        return out
    return _grouped_plain(x, w, ends)


def swiglu_plain(h: torch.Tensor) -> torch.Tensor:
    """[..., 2I] gate|up -> silu(gate) * up, [..., I], in f32 rounded once to
    h's dtype: the ATen composition."""
    gate, up = h.float().chunk(2, dim=-1)
    return (F.silu(gate) * up).to(h.dtype)


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu_plain`: the kernel on the card, the plain version on CPU
    tensors."""
    return swiglu_plain(h) if h.device.type == "cpu" else moe_cuda.swiglu(h)


def combine_plain(y: torch.Tensor, r: Routing, shared: torch.Tensor | None = None) -> torch.Tensor:
    """Sorted expert outputs y [n * k, D] -> each token's weighted sum, [n, D]
    in y's dtype: the k rows of each token gathered through ``r.rows`` (a
    permutation, so the same sum every run), weighted and summed in f32,
    rounded once; then ``shared`` [n, D] added where given."""
    out = (y[r.rows].float() * r.weights[..., None]).sum(dim=1).to(y.dtype)
    return out if shared is None else out + shared


def combine(y: torch.Tensor, r: Routing, shared: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`combine_plain`: the kernel on the card (the k choices summed in
    choice order), the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return combine_plain(y, r, shared)
    return moe_cuda.combine(y, r.rows, r.weights, shared)


def moe(x: torch.Tensor, router: dict, w13: torch.Tensor, w2: torch.Tensor, shared: Callable | None, *,
        top_k: int, scale: float, normalize: bool, tally: Tally,
        loads: torch.Tensor | None = None) -> tuple[torch.Tensor, Routing]:
    """A DeepSeek-V3 MoE layer's MLP over tokens x [n, D]: ([n, D] in x's
    dtype, the routing). ``router`` holds ``w`` [E, D] and ``bias`` [E]; w13
    [E, 2I, D] the experts' gate and up projections, w2 [E, D, I] their down;
    the routed sum, rounded to x's dtype, plus ``shared(x)`` (the shared
    experts, where given). Each expert's rows are added to ``loads`` [E] on
    the device where given; the host counts ``moe.routed_rows`` from the
    shapes. Spans: ``moe.route``, ``moe.experts``, ``moe.combine``."""
    return _dispatch(x, lambda: route(x, router["w"], router["bias"], top_k=top_k, scale=scale, normalize=normalize),
                     w13, w2, shared, tally, loads)


def moe_softmax(x: torch.Tensor, w_router: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                shared: Callable | None, *, top_k: int, tally: Tally,
                loads: torch.Tensor | None = None) -> tuple[torch.Tensor, Routing]:
    """:func:`moe` for a Granite-4.0-H MoE layer: its router ``w_router``
    [E, D] (:func:`route_softmax`), the rest as :func:`moe`."""
    return _dispatch(x, lambda: route_softmax(x, w_router, top_k=top_k), w13, w2, shared, tally, loads)


def _dispatch(x, routing: Callable[[], Routing], w13, w2, shared, tally: Tally, loads):
    with tally.span("moe.route"):
        r = routing()
        if loads is not None:
            loads.add_(r.counts)
    tally.count("moe.routed_rows", r.experts.numel())
    with tally.span("moe.experts"):
        h = grouped_mm(x[r.token], w13, r.ends)
        y = grouped_mm(swiglu(h), w2, r.ends)
    with tally.span("moe.combine"):
        return combine(y, r, None if shared is None else shared(x)), r
