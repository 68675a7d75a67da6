"""Model registry: the seven benchmark models.

Mirrors the reference registry (reference main.py:127-142) — same names, HF
ids, type tags, and per-model batch sizes (ColPali model-pinned, like the
reference's pin to 4; sized to the measured v5e optimum here) — extended
with the preprocessing recipe each model's HF processor applies, so the
device preprocessing path (ops/preprocess.py) is self-contained. A copy of
``multimodal_embedding_tpu/models/registry.py``.

Architecture hyperparameters are NOT duplicated here: they are derived from
the checkpoint's config.json at load time (models/zoo.py), exactly like the
reference's ``from_pretrained`` flow. ``debug_config`` provides a small
random-init stand-in per family for offline testing/benchmarking.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.preprocess import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
    PreprocessConfig,
)


@dataclass(frozen=True)
class ModelInfo:
    name: str
    hf_id: str
    type: str  # "dense" | "siglip" | "colpali" | "jina"
    batch_size: int | None = None  # None => use --batch-size
    trust_remote_code: bool = False
    preprocess: PreprocessConfig | None = None
    text_max_len: int = 77


MODEL_REGISTRY: list[ModelInfo] = [
    ModelInfo(
        name="ColPali-v1.3",
        hf_id="vidore/colpali-v1.3",
        type="colpali",
        # reference pins 4 (GPU OOM headroom, main.py:344); on v5e with the
        # fused attention kernel batch 8 measures fastest (benchmarks:
        # 29.0 img/s vs 26.2 at batch 4) and batch 4 is within 10% either way
        batch_size=8,
        preprocess=PreprocessConfig(
            image_size=448, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD
        ),
        text_max_len=64,
    ),
    ModelInfo(
        name="SigLIP-400M",
        hf_id="google/siglip-so400m-patch14-384",
        type="siglip",
        preprocess=PreprocessConfig(
            image_size=384, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD
        ),
        text_max_len=64,
    ),
    ModelInfo(
        name="LAION-CLIP-H",
        hf_id="laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
        type="dense",
        preprocess=PreprocessConfig(image_size=224, mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD),
    ),
    ModelInfo(
        name="Jina-CLIP-v1",
        hf_id="jinaai/jina-clip-v1",
        type="jina",
        trust_remote_code=True,
        preprocess=PreprocessConfig(
            image_size=224, resize_mode="exact", interpolation="bicubic",
            mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711),
        ),
        text_max_len=512,
    ),
    ModelInfo(
        name="MetaCLIP-H14",
        hf_id="facebook/metaclip-h14-fullcc2.5b",
        type="dense",
        trust_remote_code=True,
        preprocess=PreprocessConfig(image_size=224, mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD),
    ),
    ModelInfo(
        name="OpenAI-CLIP-L",
        hf_id="openai/clip-vit-large-patch14-336",
        type="dense",
        preprocess=PreprocessConfig(image_size=336, mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD),
    ),
    ModelInfo(
        name="Apple-DFN5B-H",
        hf_id="apple/DFN5B-CLIP-ViT-H-14-378",
        type="dense",
        trust_remote_code=True,
        preprocess=PreprocessConfig(image_size=378, mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD),
    ),
]

# Optional extras not in the default "all" set: SigLIP-Base appears in the
# reference's v15-era Flickr30k results (paper.md:15-24) but was excluded from
# the COCO roster for its weak discriminative margin (RESULTS_SUMMARY.md:114).
EXTRA_MODELS: list[ModelInfo] = [
    ModelInfo(
        name="SigLIP-Base",
        hf_id="google/siglip-base-patch16-224",
        type="siglip",
        preprocess=PreprocessConfig(
            image_size=224, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD
        ),
        text_max_len=64,
    ),
]

_BY_NAME = {m.name: m for m in MODEL_REGISTRY + EXTRA_MODELS}


def get_models_to_test(models_arg: str = "all", default_batch_size: int = 32) -> list[ModelInfo]:
    """Filter the registry by the ``--models`` comma list (reference main.py:139-142)."""
    if models_arg == "all":
        selected = MODEL_REGISTRY
    else:
        names = [n for n in models_arg.split(",") if n]
        unknown = [n for n in names if n not in _BY_NAME]
        if unknown:
            raise SystemExit(
                f"Unknown model(s) {unknown}; available: {sorted(_BY_NAME)}"
            )
        selected = [_BY_NAME[n] for n in names]
    out = []
    for m in selected:
        if m.batch_size is None:
            m = ModelInfo(**{**m.__dict__, "batch_size": default_batch_size})
        out.append(m)
    return out


def model_info(name: str) -> ModelInfo:
    return _BY_NAME[name]
