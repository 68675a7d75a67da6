"""CLI: text-to-image search against an exported embedding index.

Counterpart of ``multimodal_embedding_tpu/cli/search.py``. Runs on
``--device`` (default cuda; without a CUDA device it exits nonzero unless
``--device cpu`` was given).

    python -m multimodal_embedding_tpu_torch.cli.search \\
        --index /data/coco_clip_l.npz --model OpenAI-CLIP-L --arch-models \\
        --query "a dog catching a frisbee" --k 5
"""

from __future__ import annotations

import argparse

from ..models.encode import EncodingEngine
from ..retrieval.search import Index, search_texts
from ..utils.logging import setup_logging
from ..models.registry import model_info
from .main import load_model_for, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Search an embedding index")
    p.add_argument("--index", required=True, help=".npz from cli.encode_cli")
    p.add_argument("--model", required=True)
    p.add_argument("--query", action="append", required=True, help="repeatable")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--debug-models", action="store_true")
    p.add_argument("--arch-models", action="store_true")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or, only when asked, the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging(None)
    device = resolve_device(args.device)
    # the JAX CLI loads with each loader's default seed (0)
    model = load_model_for(model_info(args.model), debug=args.debug_models, arch=args.arch_models, seed=0,
                           device=device)
    index = Index.from_npz(args.index, device=device)
    engine = EncodingEngine(model, 8, device=device)
    results = search_texts(model, engine, index, args.query, k=args.k)
    for q, hits in zip(args.query, results):
        print(f"query: {q}")
        for doc_id, score in hits:
            print(f"  {doc_id}\t{score:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
