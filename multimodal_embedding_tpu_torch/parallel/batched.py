"""Batched application of a function over the data axis.

Counterpart of ``multimodal_embedding_tpu/parallel/batched.py``. Each batch
is padded to a multiple of the data axis by repeating its last row, each data
rank applies the function to its slice of every batch, and the outputs are
gathered in the original order with the pad dropped. The gather is one
collective for the whole input (:func:`gather_batches`), not one a batch.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .mesh import Mesh, all_gather_cat, shard_rows


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last row repeated up to ``n`` rows."""
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def local_slice(batch_rows: int, mesh: Mesh | None) -> slice:
    """This data rank's rows of a batch of ``batch_rows`` (a multiple of the
    data axis)."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, batch_rows)
    per = batch_rows // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def gather_batches(local: torch.Tensor, mesh: Mesh | None, n_batches: int) -> torch.Tensor:
    """This rank's outputs of ``n_batches`` equal batches, concatenated
    ([n_batches * b_local, ...]) -> every rank's, in row order
    ([n_batches * b_local * n_data, ...]): batch i holds data rank 0's rows,
    then rank 1's, and so on."""
    if mesh is None or mesh.n_data == 1:
        return local
    full = all_gather_cat(local.unsqueeze(0), mesh.data_group, mesh.n_data)  # [n_data, nb * bl, ...]
    per = local.shape[0] // n_batches
    full = full.reshape(mesh.n_data, n_batches, per, *local.shape[1:]).transpose(0, 1)
    return full.reshape(n_batches * mesh.n_data * per, *local.shape[1:])


def sharded_batch_apply(
    fn: Callable[..., torch.Tensor],
    inputs: torch.Tensor | tuple,
    *,
    mesh: Mesh | None,
    batch_size: int,
) -> torch.Tensor:
    """Apply ``fn`` over ``inputs`` (one tensor or a tuple sharing a leading
    axis; None entries pass through) in batches of ``batch_size`` rows,
    rounded up to a multiple of the data axis; each data rank runs its rows
    of every batch. Returns the concatenated outputs with the pad removed, on
    every rank. With one data rank the batches run as they are, unpadded."""
    tup = inputs if isinstance(inputs, tuple) else (inputs,)
    n = tup[0].shape[0]
    if n == 0:
        raise ValueError("empty input")
    n_data = 1 if mesh is None else mesh.n_data
    if n_data == 1:
        return torch.cat([fn(*(None if x is None else x[s : s + batch_size] for x in tup))
                          for s in range(0, n, batch_size)])
    eff = pad_to_multiple(batch_size, n_data)
    nb = -(-n // eff)
    outs = []
    for s in range(0, n, eff):
        batch = tuple(None if x is None else shard_rows(pad_rows(x[s : s + eff], eff), mesh) for x in tup)
        outs.append(fn(*batch))
    return gather_batches(torch.cat(outs), mesh, nb)[:n]
