"""CUDA graphs of a forward, one a shape of its inputs: the text towers'
batches on the card.

A caption batch is small beside the card: the device runs a text layer in
less time than the host takes to launch its kernels, so an eager caption
sweep runs at the host's speed, which differs from one process to the next.
A :class:`ShapeGraphs` runs the first call of each input shape eagerly, then
captures the same forward once on its own inputs (a clone of the call's;
on a side stream, the allocator's cached memory kept) and replays the
capture once, all before that call returns; every later
call of the shape copies its inputs into the capture's, replays the graph
and returns clones of the capture's outputs. One memory pool serves every
capture of a ``ShapeGraphs``: the replays run one after another on the
current stream, and each capture's outputs stay allocated.

A graph is only taken where :func:`applies`: CUDA tensors with no autograd
recording, and no tensor- or sequence-parallel mesh (their collectives are
not captured). The key holds the attention and layer implementations and
whether inference mode is on, so a graph never replays a path the settings
have since changed.

A graph reads the tensors it was captured on, the module's weights among
them: a module that holds a ``ShapeGraphs`` resets it whenever its tensors
move (``nn.Module._apply``: ``to``, ``float``, ``cuda``), and a deep copy of
it starts with none.

A replay runs none of the forward's Python: its spans do not open, and its
counts are those of the shape's eager call, added again to
``utils/profiling.py:KERNELS`` and to each tally handed in.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from .. import runtime
from .profiling import KERNELS, Tally


def applies(x: torch.Tensor) -> bool:
    """Whether a forward on ``x`` may run as a graph."""
    rt = runtime.current()
    return x.is_cuda and not torch.is_grad_enabled() and rt.tp is None and rt.sp is None


# One capture stream a device for the process, as ``torch.cuda.graph`` keeps
# one: cuBLAS holds a workspace (about 33 MB) for each stream it has run on,
# for the life of the process, so a stream a model would leave one behind
# with every model loaded.
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _clone(out):
    return tuple(x.clone() for x in out) if isinstance(out, tuple) else out.clone()


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # the capture's inputs (None where the call passed None)
    outputs: object  # the capture's output: a tensor or a tuple of tensors
    counts: list[dict[str, int]]  # each tally's counts of one call


class ShapeGraphs:
    """``fn(*args)`` as a CUDA graph a shape of ``args`` (tensors or None);
    the replays add one call's counts to :data:`KERNELS` and ``tallies``."""

    def __init__(self, *tallies: Tally):
        self.tallies = (KERNELS, *tallies)
        self.graphs: dict[tuple, _Graph] = {}
        self.pool = None

    def reset(self) -> None:
        """Drop every graph: they read the tensors they were captured on."""
        self.graphs.clear()
        self.pool = None

    def __deepcopy__(self, memo):
        """An empty copy: the original's graphs read the original's tensors."""
        return ShapeGraphs(*copy.deepcopy(self.tallies[1:], memo))

    def __call__(self, fn, *args):
        dev = next(a for a in args if a is not None).device
        key = (tuple(None if a is None else (tuple(a.shape), a.dtype, a.device) for a in args),
               runtime.attention_impl(dev), runtime.layer_impl(), torch.is_inference_mode_enabled())
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, fn, args, dev)
        for dst, src in zip(g.inputs, args):
            if dst is not None:
                dst.copy_(src)
        g.graph.replay()
        for tally, counts in zip(self.tallies, g.counts):
            for name, n in counts.items():
                tally.count(name, n)
        return _clone(g.outputs)

    def _capture(self, key: tuple, fn, args, dev: torch.device):
        before = [dict(t.counts) for t in self.tallies]
        out = fn(*args)  # first use: kernel loads, cuBLAS handles, the allocator's growth
        counts = [{k: n - b.get(k, 0) for k, n in t.counts.items() if n != b.get(k, 0)}
                  for t, b in zip(self.tallies, before)]
        kept = [dict(t.counts) for t in self.tallies]
        inputs = tuple(None if a is None else a.clone() for a in args)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # captured on a side stream, as ``torch.cuda.graph`` captures, but
        # without its ``empty_cache``: the allocator keeps what it holds
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                finally:
                    graph.capture_end()
        finally:  # the capture launched nothing: its counts are taken back
            for t, k in zip(self.tallies, kept):
                t.counts.clear()
                t.counts.update(k)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph.replay()  # the first replay uploads the graph, so no later call pays for it
        self.graphs[key] = _Graph(graph, inputs, outputs, counts)
        return out

