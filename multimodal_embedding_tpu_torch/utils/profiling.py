"""Profiler integration: the port's spans and counters, and ``torch.profiler``
traces of the device.

Counterpart of ``multimodal_embedding_tpu/utils/profiling.py``. Every span
and counter of the port lives here, in a :class:`Tally`: one process-wide
tally for the kernel wrappers (:data:`KERNELS`, its counts the launches that
``ops.launch_counts()`` reads), one per ``EncodingEngine``
(``engine.tally``) and one per MoE decoder (``models/deepseek.py``,
``DeepseekLM.tally``; ``models/granite.py``, ``GraniteLM.tally``;
``models/kimi_linear.py``, ``KimiLinearLM.tally``).

- A span (:meth:`Tally.span`) is on exactly while a ``torch.profiler``
  records: it then opens a profiler range named ``mme.<name>`` (a
  ``RecordFunction``, as ``record_function`` opens, through the profiler's
  C++ context, about a tenth of ``record_function``'s host cost), on the
  profiler's own clock beside its CUDA activity, and adds its inclusive host
  seconds and one to the tally. With no profiler running it costs the
  profiler's enabled check and returns one shared no-op context.
- A count (:meth:`Tally.count`) always counts: a plain add of host integers,
  never a read of a device tensor.

The spans, by name (each a range ``mme.<name>``):

- ``encode.images``: an image sweep (``encode_images``,
  ``encode_images_cached``, ``encode_images_streaming``);
- ``encode.image_batch``: one vision batch (``_image_batch``,
  ``_crop_batch``);
- ``encode.texts``: a caption sweep (``encode_texts``);
- ``encode.tokenize``: its host tokenization alone;
- ``encode.text_batch``: one text batch (``_text_batch``);
- ``kernel.<kernel>``: a kernel wrapper's launch (``fused_attention``,
  ``fused_attention_qkv``, ``maxsim``, ``preprocess``,
  ``fused_res_norm_matmul``, ``fused_layer_norm``, ``mlp_activation``,
  ``moe_swiglu``, ``moe_combine``, ``ssm_scan``, ``kda_scan``), on
  :data:`KERNELS`;
- ``moe.route``, ``moe.experts``, ``moe.combine``: a MoE layer's router,
  top-k, sort, expert row ends and inverse permutation; its grouped
  products and SwiGLU; its shared experts and weighted combine
  (``ops/moe.py:moe`` and ``moe_softmax``), on the decoder's tally;
- ``ssm.in``, ``ssm.scan``, ``ssm.out``: a Mamba-2 layer's ``in_proj``, conv
  and dt; its scan; its gated norm and ``out_proj``
  (``models/granite.py:GraniteLayer.ssm``), on the Granite decoder's tally;
- ``kda.in``, ``kda.scan``, ``kda.out``: a KDA layer's projections, short
  convs, log decays and beta; its recurrence; its gated norm and ``o_proj``
  (``models/kimi_linear.py:KimiLinearLayer.kda_mix``), on the Kimi-Linear
  decoder's tally.

The engine's counts: ``encode.image_rows`` and ``encode.image_pad_rows``
(rows the vision tower ran and the padding among them),
``encode.text_positions`` and ``encode.text_pad_positions`` (rows times
length the text tower ran, and the zeros of the mask among them); under a
mesh each rank counts its own rows. The MoE decoders':
``moe.routed_rows`` (tokens times top-k, a MoE layer, from shapes); the
Granite decoder's also ``ssm.tokens`` (rows times length, a Mamba-2 layer,
from shapes), the Kimi-Linear decoder's ``kda.tokens`` (rows times length, a
KDA layer, from shapes). Each expert's routed rows a MoE layer are counted on the
device instead (``expert_loads``, one add a layer, no sync) and read by
``take_expert_loads`` after a barrier. :data:`KERNELS` also counts
``grouped_mm``, each grouped expert product on the card, the decoders'
``moe_swiglu`` and ``moe_combine`` kernels, the Granite decoder's
``ssm_scan`` (again as ``ssm_scan_chunked`` on the kernel's chunked body) and
the Kimi-Linear decoder's ``kda_scan``.

A text batch on the card replays a CUDA graph (``utils/graphs.py``): the
replay opens none of the forward's spans, and adds again the counts that
the forward's eager call of the same shape made.

With a directory, :func:`maybe_trace` records CPU and CUDA activity of the
enclosed region, writes a Chrome trace (view in Perfetto) that carries the
``mme.*`` ranges and a text table of the operators by device time, and logs
the table's top rows; without one it is a no-op. The CLI enables it with
``--profile-dir``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("mme_tpu")

_OFF = contextlib.nullcontext()  # the one span handed out while no profiler records
_RANGE = torch._C._profiler._RecordFunctionFast


class _Span:
    """A profiler range and its host seconds, added to ``tally``."""

    __slots__ = ("tally", "name", "range", "t0")

    def __init__(self, tally: Tally, name: str):
        self.tally, self.name = tally, name
        self.range = _RANGE("mme." + name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        t = self.tally
        t.seconds[self.name] = t.seconds.get(self.name, 0.0) + dt
        t.n_spans[self.name] = t.n_spans.get(self.name, 0) + 1


class Tally:
    """Counts, and the inclusive host seconds and number of each span
    entered while a profiler recorded, in host memory."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.seconds: dict[str, float] = {}
        self.n_spans: dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def span(self, name: str):
        """A context: the range ``mme.<name>`` while a profiler records, else
        the shared no-op."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def reset(self) -> None:
        self.counts.clear()
        self.seconds.clear()
        self.n_spans.clear()


# The kernel wrappers' tally: launches by kernel (the keys of
# ops.launch_counts) and the ``kernel.<kernel>`` spans.
KERNELS = Tally()


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, row_limit: int = 25):
    if not profile_dir:
        yield
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info(f"Capturing device trace to {out}")
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    table = prof.key_averages().table(sort_by=sort, row_limit=row_limit)
    (out / "ops.txt").write_text(table)
    logger.info(f"Trace written to {out} (trace.json, ops.txt); top operators by {sort}:\n{table}")
