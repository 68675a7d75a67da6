"""CLI: encode a dataset to embeddings on disk (the index-building API).

Counterpart of ``multimodal_embedding_tpu/cli/encode_cli.py``, writing the
same ``.npz`` keys: ``image_embeddings`` (f32, L2-normalized; per-token for
multi-vector models), ``imgids`` and, with ``--texts`` (default), every
caption's ``text_embeddings``, ``caption_image_index`` and, for multi-vector
models, ``text_masks``. Runs on ``--device`` (default cuda; without a CUDA
device it exits nonzero unless ``--device cpu`` was given).

    python -m multimodal_embedding_tpu_torch.cli.encode_cli \\
        --model OpenAI-CLIP-L --dataset synthetic --arch-models --sample-size 1000 \\
        --output /data/coco_clip_l.npz
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..data.coco import load_benchmark_dataset
from ..models.encode import EncodingEngine
from ..models.registry import model_info
from ..utils.logging import setup_logging
from .main import load_model_for, resolve_device

logger = logging.getLogger("mme_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Encode a dataset to embeddings")
    p.add_argument("--model", required=True, help="Registry model name")
    p.add_argument("--dataset", default="coco", choices=["coco", "flickr30k", "docvqa", "synthetic"])
    p.add_argument("--sample-size", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cache-dir", type=str, default="./coco_images")
    p.add_argument("--output", required=True, help="Output .npz")
    p.add_argument("--debug-models", action="store_true")
    p.add_argument("--arch-models", action="store_true")
    p.add_argument("--texts", action=argparse.BooleanOptionalAction, default=True,
                   help="Also encode all captions")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or, only when asked, the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging(None)
    device = resolve_device(args.device)
    info = model_info(args.model)
    model = load_model_for(info, debug=args.debug_models, arch=args.arch_models, seed=args.seed, device=device)

    records = load_benchmark_dataset(args.dataset, cache_dir=args.cache_dir, sample_size=args.sample_size,
                                     seed=args.seed)
    engine = EncodingEngine(model, info.batch_size or args.batch_size, device=device)

    img = engine.encode_images([r["image"] for r in records])
    out = {
        "image_embeddings": img.embeddings.float().cpu().numpy(),
        "imgids": np.asarray([r["imgid"] for r in records]),
    }
    if args.texts:
        caps = [c for r in records for c in r["captions"]]
        txt = engine.encode_texts(caps)
        out["text_embeddings"] = txt.embeddings.float().cpu().numpy()
        out["caption_image_index"] = np.asarray([i for i, r in enumerate(records) for _ in r["captions"]])
        if txt.mask is not None:
            out["text_masks"] = txt.mask.cpu().numpy()
    np.savez_compressed(args.output, **out)
    logger.info(
        f"Wrote {out['image_embeddings'].shape} image embeddings"
        + (f" and {out['text_embeddings'].shape} text embeddings" if args.texts else "")
        + f" to {args.output}"
    )
    print(args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
