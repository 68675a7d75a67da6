"""Caption normalization (reference main.py:220-226).

The COCO-Karpathy ``sentences`` column is sometimes a stringified python list;
coerce robustly to ``list[str]``.
"""

from __future__ import annotations

import ast
from typing import Any


def get_all_captions(item: dict, col_name: str = "sentences") -> list[str]:
    val: Any = item.get(col_name, [])
    if isinstance(val, str):
        s = val.strip()
        if s.startswith("[") and s.endswith("]"):
            try:
                val = ast.literal_eval(s)
            except (ValueError, SyntaxError):
                pass
    if not isinstance(val, list):
        val = [str(val)]
    return [str(v) for v in val]


def caps_per_image(records: list) -> int:
    """COCO protocol uses exactly 5 captions per image (reference
    main.py:513-517); datasets with fewer (e.g. DocVQA's single question)
    use what they have."""
    return min(5, min(len(r["captions"]) for r in records))
