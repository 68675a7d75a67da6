"""The (data, model) mesh of ranks, on ``torch.distributed``.

Counterpart of ``multimodal_embedding_tpu/parallel/mesh.py``. The JAX package
runs one controller over every device; the port runs one process per rank,
launched by ``torchrun`` (``python -m torch.distributed.run``), which sets
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. :func:`init_distributed` reads
them; with ``WORLD_SIZE`` unset or 1 it creates no process group and every
path runs as on one device.

Ranks form a ``(data, model)`` grid, rank = data index * n_model + model
index: torchrun numbers ranks host-major, so the model axis stays within a
host and the data axis is outer. :class:`Mesh` holds this rank's coordinates
and the process group of each axis it lies on (None where the axis has size
1: no collective is issued there).

The JAX ``data_sharding`` and ``replicated_sharding`` are placements that
XLA turns into transfers; here they are two functions, :func:`shard_rows`
(this data rank's rows) and :func:`gather_rows` (the data axis's rows
concatenated in rank order). Collectives are the list-form ``all_gather``,
``all_reduce`` and ``broadcast`` only: gloo, the backend of ranks on the CPU
or sharing one card, implements these for CUDA tensors. Where XLA derives
the gradient of a sharded program, the decoders' training path under tensor
parallelism takes Megatron's two operators, :func:`copy_to_model` and
:func:`reduce_from_model`, autograd Functions over the model axis.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

logger = logging.getLogger("mme_tpu")

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 900


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of ranks and this rank's place in it."""

    n_data: int
    n_model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = field(default=None, repr=False)  # None: the axis has one rank
    model_group: object = field(default=None, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the one rank that writes a run's files and log lines."""
    return world_rank() == 0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def resolve_rank_device(name: str) -> torch.device:
    """This rank's device: ``cuda`` is ``cuda:LOCAL_RANK``, ``cuda:N`` card N
    for every rank, ``cpu`` the CPU. Never falls back from a card to the CPU:
    a missing card raises."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    dev = torch.device(name)
    if dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    if dev.index >= torch.cuda.device_count():
        raise SystemExit(f"{dev} does not exist: {torch.cuda.device_count()} CUDA device(s) visible")
    return dev


def backend_for(device: torch.device, device_name: str) -> str:
    """NCCL when each rank has a card of its own, gloo on the CPU or when the
    ranks share one card (NCCL refuses two ranks on one GPU)."""
    if device.type != "cuda":
        return "gloo"
    shared = device_name != "cuda" and _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1)) > 1
    return "gloo" if shared else "nccl"


def init_distributed(device_name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the torchrun world, if there is one, and return this rank's
    device (:func:`resolve_rank_device`), made current on a card before any
    kernel launches. A process group set up by the caller (the tests) is
    used as it is. With ``WORLD_SIZE`` unset or 1 nothing is created."""
    device = resolve_rank_device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ws = _env_int("WORLD_SIZE", 1)
    if not dist.is_initialized() and ws > 1:
        dist.init_process_group(backend_for(device, device_name), init_method="env://", world_size=ws,
                                rank=_env_int("RANK", 0), timeout=timedelta(seconds=timeout_s))
    return device


@contextlib.contextmanager
def distributed(device_name: str):
    """:func:`init_distributed` for the body of a ``with``, which gets this
    rank's device; a process group made here is ended after it (one the
    caller made stays)."""
    made = not dist.is_initialized()
    device = init_distributed(device_name)
    try:
        yield device
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def get_mesh(n_data: int | None = None, n_model: int = 1, *, world: int | None = None) -> Mesh:
    """Build a ``(data, model)`` mesh over the world's ranks (``world``
    given: the shape alone, no process group). ``n_data`` defaults to
    ``world // n_model``. In a world of more than one rank the mesh covers
    every rank, and every rank must call this with the same arguments (each
    axis group is created collectively)."""
    ranks = world_size() if world is None else world
    if n_model > ranks:
        raise ValueError(f"--tensor-parallel {n_model} needs {n_model} devices, have {ranks}")
    if n_data is None:
        n_data = ranks // n_model
    need = n_data * n_model
    if n_data < 1 or need > ranks:
        raise ValueError(f"mesh ({n_data}x{n_model}) needs {need} devices, have {ranks}")
    if world is not None or ranks == 1:
        return Mesh(n_data, n_model)
    if need != ranks:
        raise ValueError(f"mesh ({n_data}x{n_model}) must cover all {ranks} ranks")
    me = dist.get_rank()
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(n_model):
        members = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(members) if n_data > 1 else None
        if me in members:
            data_group = g
    for d in range(n_data):
        members = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(members) if n_model > 1 else None
        if me in members:
            model_group = g
    return Mesh(n_data, n_model, me // n_model, me % n_model, data_group, model_group)


def get_multihost_mesh(n_model: int = 1, *, world: int | None = None, local_world: int | None = None) -> Mesh:
    """The mesh of a multi-host run: the data axis outer (across hosts), the
    model axis inner, so model-axis collectives stay within a host; torchrun's
    host-major rank order gives exactly :func:`get_mesh`'s grid. Refuses a
    model axis that would straddle hosts."""
    local = local_world if local_world is not None else _env_int("LOCAL_WORLD_SIZE", world_size())
    if local % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide {local} ranks per host")
    ranks = world_size() if world is None else world
    return get_mesh(ranks // n_model, n_model, world=world)


# --- collectives ----------------------------------------------------------------


def all_gather_cat(x: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order (list-form ``all_gather``); ``x`` itself when ``group`` is None."""
    if group is None or n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place, in x's dtype; x itself when
    ``group`` is None. No gradient rule: for no-grad paths."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward, the gradient summed over the
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": the sum over the group forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a column-split projection: unchanged, and its gradient
    (each rank's part, from its own columns) summed over ``group`` in the
    backward. ``x`` itself when ``group`` is None."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row-split projection's partial product summed over ``group``, in
    x's dtype; the gradient passes through unchanged. ``x`` itself when
    ``group`` is None."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def broadcast_from_first(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the first rank of ``group`` holds it, written into ``x`` on
    every rank of the group (a device tensor stays on its device); ``x``
    itself when ``group`` is None."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def shard_rows(x, mesh: Mesh | None):
    """This data rank's rows of ``x``, a tensor or a host array (rows must
    divide the data axis)."""
    if mesh is None or mesh.n_data == 1:
        return x
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"{n} rows do not divide the data axis of {mesh.n_data}")
    per = n // mesh.n_data
    return x[mesh.data_rank * per : (mesh.data_rank + 1) * per]


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every data rank's rows, in rank order, on every rank."""
    if mesh is None:
        return x
    return all_gather_cat(x, mesh.data_group, mesh.n_data)


def share_from_rank0(arr, device) -> torch.Tensor | None:
    """A 2-D host array (or None) as a tensor on ``device``, rank 0's on
    every rank: its shape, then its values are broadcast. In a world of one,
    the array itself."""
    t = None if arr is None else torch.tensor(arr, device=device)  # a copy: the broadcast writes into it
    if world_size() == 1:
        return t
    if t is not None and t.dim() != 2:
        raise ValueError(f"share_from_rank0 takes 2-D arrays, not {tuple(t.shape)}")
    head = torch.tensor([-1, -1] if t is None else list(t.shape), dtype=torch.int64, device=device)
    dist.broadcast(head, src=0)
    shape = tuple(int(x) for x in head.tolist())
    if shape[0] < 0:
        return None
    if t is None or tuple(t.shape) != shape:
        t = torch.empty(shape, dtype=torch.int64 if t is None else t.dtype, device=device)
    dist.broadcast(t, src=0)
    return t


def barrier(device: torch.device | None = None) -> None:
    """Wait for every rank of the world, after this rank's queued device
    work; a no-op in a world of one."""
    if world_size() == 1:
        return
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
