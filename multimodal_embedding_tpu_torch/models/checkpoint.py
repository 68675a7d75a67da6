"""Native parameter checkpoints for converted models.

Counterpart of ``multimodal_embedding_tpu/models/checkpoint.py``, and the
same file format: the converted param tree flattened into one compressed
``.npz`` (keys are ``/``-joined tree paths) with the model config as JSON
under ``__config__``, each dataclass marked by ``__dataclass__``. A file
written by either package loads in the other. Reloading needs neither
transformers nor the HF checkpoint. Used by
``load_model(..., native_cache_dir=...)``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _config_to_json(cfg: Any) -> str:
    def to_jsonable(o):
        # by hand: dataclasses.asdict would drop the markers of nested dataclasses
        if dataclasses.is_dataclass(o):
            d = {"__dataclass__": type(o).__name__}
            for f in dataclasses.fields(o):
                d[f.name] = to_jsonable(getattr(o, f.name))
            return d
        if isinstance(o, tuple):
            return list(o)
        return o

    return json.dumps(to_jsonable(cfg))


def _config_types() -> dict[str, type]:
    from .colpali import ColPaliConfig
    from .gemma import GemmaConfig
    from .jina import Eva02Config, JinaBertConfig, JinaClipConfig
    from .towers import DualEncoderConfig, TextConfig, VisionConfig

    types = (ColPaliConfig, GemmaConfig, DualEncoderConfig, TextConfig, VisionConfig,
             Eva02Config, JinaBertConfig, JinaClipConfig)
    return {t.__name__: t for t in types}


def _config_from_json(s: str) -> Any:
    types = _config_types()

    def hook(d):
        name = d.pop("__dataclass__", None)
        if name is None:
            return d
        if name not in types:
            raise ValueError(f"native checkpoint config type {name!r} is not ported to the "
                             f"PyTorch/CUDA package (known: {sorted(types)})")
        t = types[name]
        fields = {f.name for f in dataclasses.fields(t)}
        return t(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in fields})

    return json.loads(s, object_hook=hook)


def save_params(path: Path | str, params: Any, cfg: Any) -> None:
    """Write a param tree (numpy leaves) and its config to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    config = np.frombuffer(_config_to_json(cfg).encode(), dtype=np.uint8)
    np.savez_compressed(path, __config__=config, **_flatten(params))


def load_params(path: Path | str) -> tuple[dict, Any]:
    """Read ``(param tree with numpy leaves, config)`` from ``path``."""
    with np.load(Path(path)) as data:
        cfg = _config_from_json(bytes(data["__config__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__config__"}
    return _unflatten(flat), cfg
