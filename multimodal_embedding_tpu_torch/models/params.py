"""The weight carrier: a JAX param tree, given as numpy arrays, to the port's
modules.

The JAX package keeps params as nested dicts with the layers of a stack
along a leading axis: a tower's ``encoder/<name>``, Gemma's ``layers/<name>``
and Jina's ``blocks/<name>`` are ``[L, ...]``. The port's modules use the
same names and layouts, with the stacks unrolled (``_UNROLLED``); so the
carrier is a rename plus an unstack, and every parity test feeds both
packages the same weights through it. Integer leaves (ColPali's
``image_suffix_ids``) stay integers.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# stacked subtree -> the port's name for its layer list: ``encoder/<name>``
# [L, ...] becomes ``encoder.layers.<i>.<name>``, ``layers/<name>``
# ``layers.<i>.<name>``, ``blocks/<name>`` ``blocks.<i>.<name>``
_UNROLLED = {"encoder": "encoder.layers", "layers": "layers", "blocks": "blocks"}


def params_from_jax(tree: Mapping[str, Any], dtype=torch.float32, *, device) -> dict[str, torch.Tensor]:
    """Flatten a JAX param tree (leaves: numpy arrays) into a state dict of
    the port's module names, on ``device`` in ``dtype``. Load it with
    ``module.load_state_dict(state)``."""
    state: dict[str, torch.Tensor] = {}

    def put(name: str, arr) -> None:
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.integer):
            state[name] = torch.from_numpy(arr.copy()).to(device=device)
        else:
            state[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    def leaves(node: Mapping[str, Any], path: str):
        for key, val in node.items():
            if isinstance(val, Mapping):
                yield from leaves(val, f"{path}{key}.")
            else:
                yield f"{path}{key}", val

    for name, arr in leaves(tree, ""):
        parts = name.split(".")
        stack = next((j for j, key in enumerate(parts) if key in _UNROLLED), None)
        if stack is None:
            put(name, arr)
            continue
        # [L, ...]-stacked leaf -> one entry per layer
        unrolled = ".".join([*parts[:stack], _UNROLLED[parts[stack]]])
        rest = ".".join(parts[stack + 1 :])
        arr = np.asarray(arr)
        for i in range(arr.shape[0]):
            put(f"{unrolled}.{i}.{rest}", arr[i])
    return state


def load_tree(module: nn.Module, tree: Mapping[str, Any], dtype=torch.float32, *, device) -> nn.Module:
    """Load a JAX param tree into ``module``, every name matched strictly.
    The tree's tensors, on ``device`` in ``dtype``, take the place of the
    module's own (``assign``), so a module built on the ``meta`` device holds
    the tree's weights as their only copy. A tensor the tree does not fill (a
    non-persistent buffer left on ``meta``) raises. Returns ``module``."""
    module.load_state_dict(params_from_jax(tree, dtype, device=device), strict=True, assign=True)
    left = [name for name, t in (*module.named_parameters(), *module.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"{type(module).__name__}: not filled by the tree: {left[:5]}")
    return module
