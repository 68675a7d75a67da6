"""The weight carrier: a JAX param tree, given as numpy arrays, to the port's
modules.

The JAX package keeps params as nested dicts with the encoder's layers
stacked along a leading axis (``encoder/<name>`` is ``[L, ...]``). The port's
modules use the same names and layouts, with the stack unrolled into
``encoder.layers.<i>``; so the carrier is a rename plus an unstack, and every
parity test feeds both packages the same weights through it.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], dtype=torch.float32, *, device) -> dict[str, torch.Tensor]:
    """Flatten a JAX param tree (leaves: numpy arrays) into a state dict of
    the port's module names, on ``device`` in ``dtype``. Load it with
    ``module.load_state_dict(state)``."""
    state: dict[str, torch.Tensor] = {}

    def put(name: str, arr) -> None:
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    def leaves(node: Mapping[str, Any], path: str):
        for key, val in node.items():
            if isinstance(val, Mapping):
                yield from leaves(val, f"{path}{key}.")
            else:
                yield f"{path}{key}", val

    for name, arr in leaves(tree, ""):
        head, sep, rest = name.partition("encoder.")
        if sep:  # [L, ...]-stacked encoder leaf -> one entry per layer
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                put(f"{head}encoder.layers.{i}.{rest}", arr[i])
        else:
            put(name, arr)
    return state
