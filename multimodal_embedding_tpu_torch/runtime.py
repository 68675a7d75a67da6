"""The run's implementation and mesh choices, and the one rule that resolves
``"auto"``. It imports nothing of the package, so every module may read it:
:func:`current`, :func:`attention_impl`, :func:`layer_impl`. :func:`using` is
the only writer, and it puts back what it found on exit.

``attention``, the towers' self-attention:
 - "pallas":   the fused attention kernel (ops/attention_cuda.py; the TPU
               package's name for its kernel route), on CPU tensors its
               plain version;
 - "flash":    the TPU package's route to jax's flash-attention kernel
               (JAX models/layers.py:_flash_sdpa): self-attention with no key
               mask goes to the same fused kernel over the real T tokens;
               every other call (a key mask, cross attention) takes "xla";
 - "xla":      einsum SDPA with f32 logits and -inf masking;
 - "xla_bf16": the same with logits computed in the model dtype;
 - "auto":     "pallas" for CUDA tensors, "xla" on the CPU; no TPU
               crossover carries over.
``layer``, the encoder layer:
 - "xla":   each EncoderLayer as separate PyTorch ops;
 - "fused": the residual+LN+matmul prologue kernel (ops/fused_ln_matmul_cuda.py)
            feeding the stacked-QKV attention kernel; on CPU tensors their
            plain versions;
 - "auto":  "xla", as in the JAX package, whose reason is a TPU measurement;
            no H100 measurement has chosen between the two yet (PERF.md).
``tp``: the encoding engine splits the weights once while it is set
(``parallel/tp.py:shard_params_tp``); each rank's attention then runs the
kernel on its own heads. ``sp``: ColPali's Gemma runs on this rank's token
shard where the model axis divides the sequence (``parallel/sp.py``). A mesh
whose model axis is 1 or less changes nothing and is stored as None.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from .parallel.mesh import Mesh

ATTENTION_IMPLS = ("auto", "xla", "xla_bf16", "pallas", "flash")
LAYER_IMPLS = ("auto", "xla", "fused")


def resolve(impl: str, device) -> str:
    """``"auto"`` is the kernel ("pallas") on a CUDA device and the plain
    version ("xla") anywhere else; any other value is returned as it is."""
    if impl != "auto":
        return impl
    return "pallas" if torch.device(device).type == "cuda" else "xla"


@dataclasses.dataclass(frozen=True)
class Runtime:
    attention: str = "auto"
    layer: str = "auto"
    tp: Mesh | None = None
    sp: Mesh | None = None

    def __post_init__(self):
        if self.attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention impl must be one of {ATTENTION_IMPLS}, not {self.attention!r}")
        if self.layer not in LAYER_IMPLS:
            raise ValueError(f"layer impl must be one of {LAYER_IMPLS}, not {self.layer!r}")
        for axis in ("tp", "sp"):
            if getattr(self, axis) is not None and getattr(self, axis).n_model <= 1:
                object.__setattr__(self, axis, None)


_current = Runtime()


def current() -> Runtime:
    return _current


def attention_impl(device) -> str:
    """The attention implementation for tensors on ``device`` (never "auto")."""
    return resolve(_current.attention, device)


def layer_impl() -> str:
    """The encoder-layer implementation (never "auto")."""
    return "xla" if _current.layer == "auto" else _current.layer


@contextlib.contextmanager
def using(**changes):
    """The current settings with ``changes`` for the body, every value
    checked before anything changes; the previous ones back on exit, an
    exception included."""
    global _current
    prev, _current = _current, dataclasses.replace(_current, **changes)
    try:
        yield _current
    finally:
        _current = prev
