"""Dataset forensics (reference A27: inspect_coco.py, inspect_caption_counts.py,
test_flickr_splits.py, find_karpathy_split.py, download_karpathy_split.py).

Subcommands:
- schema:    probe a dataset's columns/keys and a sample record
- captions:  caption-count histogram (motivates the >=5-caption prefilter)
- splits:    validate Flickr30k candidates against the Karpathy split sizes
             (train~29k / val~1k / test~1k, test_flickr_splits.py:60-82)
- karpathy:  locate + parse the official ``dataset_flickr30k.json`` /
             ``dataset_coco.json`` Karpathy split file into per-split ID
             lists (download_karpathy_split.py:98-133)
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

from ..data.captions import get_all_captions


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Dataset forensics")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("schema")
    s.add_argument("--dataset", default="yerevann/coco-karpathy")
    s.add_argument("--split", default="test")

    c = sub.add_parser("captions")
    c.add_argument("--dataset", default="yerevann/coco-karpathy")
    c.add_argument("--split", default="test")
    c.add_argument("--column", default="sentences")

    f = sub.add_parser("splits")
    f.add_argument("--candidates", default="nlphuji/flickr30k,lmms-lab/flickr30k")

    k = sub.add_parser("karpathy")
    k.add_argument("--json", default=None,
                   help="Path to dataset_flickr30k.json / dataset_coco.json; "
                        "when omitted, searches --search-dirs")
    k.add_argument("--search-dirs", default=".,./coco_images,~/.cache",
                   help="Comma-separated directories to scan for the split json")
    k.add_argument("--out-dir", default=".",
                   help="Where to write flickr30k_{train,val,test}_ids.txt")
    k.add_argument("--prefix", default="flickr30k")
    return p.parse_args(argv)


KARPATHY_FLICKR = {"train": (28000, 30000), "val": (900, 1100), "test": (900, 1100)}


def cmd_schema(args) -> int:
    from datasets import load_dataset

    ds = load_dataset(args.dataset, split=args.split, num_proc=1)
    print(f"{args.dataset}[{args.split}]: {len(ds)} rows")
    print("columns:", ds.column_names)
    item = ds[0]
    for k, v in item.items():
        desc = f"{type(v).__name__}"
        if isinstance(v, str):
            desc += f" = {v[:80]!r}"
        elif isinstance(v, list):
            desc += f"[{len(v)}]"
        print(f"  {k}: {desc}")
    return 0


def cmd_captions(args) -> int:
    from datasets import load_dataset

    ds = load_dataset(args.dataset, split=args.split, num_proc=1)
    counts = Counter(len(get_all_captions(item, args.column)) for item in ds)
    print(f"caption-count histogram over {len(ds)} rows:")
    for n_caps in sorted(counts):
        print(f"  {n_caps} captions: {counts[n_caps]} images")
    ge5 = sum(v for k, v in counts.items() if k >= 5)
    print(f">=5 captions: {ge5} ({100 * ge5 / len(ds):.1f}%) — the prefilter keeps these")
    return 0


def cmd_splits(args) -> int:
    from datasets import get_dataset_split_names, load_dataset

    ok_any = False
    for cand in args.candidates.split(","):
        print(f"\n=== {cand} ===")
        try:
            splits = get_dataset_split_names(cand)
        except Exception as e:
            print(f"  ❌ cannot enumerate splits: {e}")
            continue
        for split in splits:
            ds = load_dataset(cand, split=split)
            sizes = Counter(x.get("split", split) for x in ds) if "split" in ds.column_names else {split: len(ds)}
            for name, n in sizes.items():
                band = KARPATHY_FLICKR.get(name)
                verdict = "✅" if band and band[0] <= n <= band[1] else "❌"
                print(f"  {name}: {n} {verdict}")
                ok_any = ok_any or verdict == "✅"
    return 0 if ok_any else 1


def find_karpathy_json(search_dirs: list[str]) -> Path | None:
    """Locate an official Karpathy split json (reference
    find_karpathy_split.py's manual-approach step 3, automated)."""
    names = ("dataset_flickr30k.json", "dataset_coco.json", "dataset_flickr8k.json")
    for d in search_dirs:
        root = Path(d).expanduser()
        if not root.is_dir():
            continue
        for name in names:
            hit = next(iter(root.rglob(name)), None)
            if hit is not None:
                return hit
    return None


def parse_karpathy_split(json_path: Path, out_dir: Path, prefix: str) -> dict[str, int]:
    """Parse {images: [{split, imgid/cocoid/filename, ...}]} into per-split ID
    files (reference download_karpathy_split.py:98-133; 'restval' merges into
    'train' as is standard for retrieval benchmarks)."""
    with open(json_path) as f:
        data = json.load(f)

    splits: dict[str, list[str]] = {"train": [], "val": [], "test": []}
    for img in data["images"]:
        split = img["split"]
        if split == "restval":
            split = "train"
        img_id = img.get("imgid")
        if img_id is None:
            img_id = img.get("cocoid")
        if img_id is None:
            img_id = img["filename"].split(".")[0]
        splits[split].append(str(img_id))

    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    for split_name, ids in splits.items():
        out = out_dir / f"{prefix}_{split_name}_ids.txt"
        out.write_text("\n".join(ids))
        counts[split_name] = len(ids)
        print(f"✓ Wrote {len(ids):,} IDs to {out}")
    return counts


def cmd_karpathy(args) -> int:
    if args.json:
        path = Path(args.json)
        if not path.exists():
            print(f"❌ {path} not found")
            return 1
    else:
        path = find_karpathy_json(args.search_dirs.split(","))
        if path is None:
            print("❌ no dataset_{flickr30k,coco,flickr8k}.json found under "
                  f"{args.search_dirs}; download it from Karpathy's deepimagesent "
                  "page and pass --json")
            return 1
        print(f"Found split file: {path}")
    counts = parse_karpathy_split(path, Path(args.out_dir), args.prefix)
    print("Summary: " + ", ".join(f"{k}={v:,}" for k, v in counts.items()))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return {
        "schema": cmd_schema,
        "captions": cmd_captions,
        "splits": cmd_splits,
        "karpathy": cmd_karpathy,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
