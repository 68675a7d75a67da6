"""Score-matrix checkpoint and resume (``--score-cache-dir``).

Counterpart of ``multimodal_embedding_tpu/stats/score_cache.py``, with the
same file layout: ``scores_<model>_<dataset fingerprint>_<numerics>.npz``
holding ``s_t2i`` and ``s_i2t`` (f32) and ``encoding_time`` (f64), so a
rerun with the same model and dataset skips encoding and goes straight to
the bootstrap, with the first run's encode time kept for QPS.

The numerics part of the key names this package and its routes: the
device kind, the attention and layer implementations, the preprocess and
MaxSim routes, each resolved as the run resolves them. It starts with
``torch-``, so this package never reads a score matrix that the JAX package
wrote, nor the other way round.
"""

from __future__ import annotations

import hashlib
import logging
import re
import zipfile
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("mme_tpu")


def dataset_fingerprint(records: list[dict]) -> str:
    h = hashlib.sha1()
    h.update(str(len(records)).encode())
    for r in records[:: max(1, len(records) // 128)]:  # sampled, order-sensitive
        h.update(str(r.get("imgid", "")).encode())
        h.update(r["captions"][0].encode())
    return h.hexdigest()[:16]


def numerics_fingerprint(preprocess_impl: str = "auto", maxsim_impl: str = "auto", *, device) -> str:
    """Everything that changes the score matrices' numerics, so that a rerun
    under other implementations or on another device misses the cache."""
    from ..models.layers import get_attention_impl, get_layer_impl

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    if preprocess_impl == "auto":  # as EncodingEngine resolves it
        preprocess_impl = "pallas" if on_card else "xla"
    # as ops/maxsim_cuda.py:maxsim_scores routes: CPU tensors take the plain version
    maxsim_impl = "xla" if not on_card or maxsim_impl == "xla" else "pallas"
    key = f"torch-{kind}-{get_attention_impl(dev)}-{get_layer_impl()}-{preprocess_impl}-{maxsim_impl}"
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def cache_path(cache_dir: str, model_name: str, fingerprint: str, numerics: str) -> Path:
    return Path(cache_dir) / f"scores_{model_name}_{fingerprint}_{numerics}.npz"


def load_scores(cache_dir: str, model_name: str, records: list[dict], preprocess_impl: str = "auto",
                maxsim_impl: str = "auto", *, device):
    """Returns (s_t2i, s_i2t, encoding_time) as numpy arrays and a float, or None."""
    numerics = numerics_fingerprint(preprocess_impl, maxsim_impl, device=device)
    p = cache_path(cache_dir, model_name, dataset_fingerprint(records), numerics)
    if not p.exists():
        return None
    try:
        with np.load(p) as data:
            out = data["s_t2i"], data["s_i2t"], float(data["encoding_time"])
        logger.info(f"Resuming from score cache {p} (encode skipped)")
        return out
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile) as e:
        logger.warning(f"Score cache {p} unreadable ({e}); re-encoding")
        return None


def save_scores(cache_dir: str, model_name: str, records: list[dict], s_t2i, s_i2t, encoding_time: float,
                preprocess_impl: str = "auto", maxsim_impl: str = "auto", *, device) -> None:
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    numerics = numerics_fingerprint(preprocess_impl, maxsim_impl, device=device)
    p = cache_path(cache_dir, model_name, dataset_fingerprint(records), numerics)
    np.savez(
        p,
        s_t2i=torch.as_tensor(s_t2i).float().cpu().numpy(),
        s_i2t=torch.as_tensor(s_i2t).float().cpu().numpy(),
        encoding_time=np.float64(encoding_time),
    )
    logger.info(f"Score matrices checkpointed to {p}")
