"""What the benchmark takes from the port: a dual encoder loaded through the
port's own loader, and an encoding engine that keeps what it produced.

Weights reach the port as an HF-layout state dict, through
``models/convert.py`` and ``models/zoo.py:dual_encoder_from_params``, as a
checkpoint would. The tokenizer is the port's word tokenizer for
random-weight models (``models/arch.py:arch_tokenizer``).
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import torch

from multimodal_embedding_tpu_torch.models import convert, zoo
from multimodal_embedding_tpu_torch.models.arch import arch_tokenizer
from multimodal_embedding_tpu_torch.models.encode import EncodingEngine
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.ops.preprocess import PreprocessConfig

from .harness import sub_seed
from .weights import make_state_dict

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_model(cfg: dict, state_dict: dict, device) -> zoo.LoadedModel:
    """The configuration's dual encoder on ``device`` in its dtype, its
    weights from an HF-layout ``state_dict``, on the port's default paths."""
    hf = SimpleNamespace(vision_config=SimpleNamespace(**cfg["vision_config"]),
                         text_config=SimpleNamespace(**cfg["text_config"]), projection_dim=cfg.get("projection_dim"))
    if cfg["family"] == "clip":
        mcfg = convert.clip_config_from_hf(hf)
        tree = convert.clip_params_from_hf(state_dict, mcfg)
    else:
        mcfg = convert.siglip_config_from_hf(hf)
        tree = convert.siglip_params_from_hf(state_dict, mcfg)
    model = zoo.dual_encoder_from_params(tree, mcfg, device=device, dtype=DTYPES[cfg["dtype"]])
    info = model_info(cfg["registry"])
    recipe = cfg["preprocess"]
    pre = PreprocessConfig(image_size=recipe["image_size"], resize_mode=recipe["resize_mode"],
                           interpolation=recipe["interpolation"], mean=tuple(recipe["mean"]), std=tuple(recipe["std"]))
    return zoo.LoadedModel(info=info, cfg=mcfg, model=model, preprocess=pre, tokenize=arch_tokenizer(info, mcfg),
                           weights_provenance="arch-random")


def load(cell) -> tuple[dict, zoo.LoadedModel, RecordingEngine]:
    """A cell's HF-layout weights drawn from its seed on its device, the
    port's model on them, and the engine at the configuration's batch."""
    cfg = cell.config
    sd = make_state_dict(cfg, sub_seed(cell.seed, 1), device=cell.device, dtype=DTYPES[cfg["dtype"]])
    model = load_model(cfg, sd, cell.device)
    return sd, model, RecordingEngine(model, cfg["batch_size"], device=cell.device, spans=cell.spans)


class RecordingEngine(EncodingEngine):
    """The port's engine, keeping each sweep's embeddings in ``outputs`` for
    the check and, in traced runs (``spans`` given), the host seconds of
    each sweep in ``spans`` under a ``perfbench.<sweep>`` profiler range.
    Both sweeps end in the engine's own device barrier."""

    def __init__(self, *args, spans: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.outputs: list[torch.Tensor] = []
        self.spans = spans

    @contextlib.contextmanager
    def _span(self, name: str):
        if self.spans is None:
            yield
            return
        with torch.profiler.record_function(f"perfbench.{name}"):
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def encode_images_cached(self, cache):
        with self._span("image_sweep"):
            res = super().encode_images_cached(cache)
        self.outputs.append(res.embeddings)
        return res

    def encode_texts(self, texts):
        with self._span("text_sweep"):
            res = super().encode_texts(texts)
        self.outputs.append(res.embeddings)
        return res
