"""The traffic generator: a frozen copy of ``data/synthetic.py`` that draws
COCO-like records from a seed, with the images made on the device.

Each record has five captions built from the failure-analysis keyword
tables (colour, object, count, spatial relation) and an image of one of the
traffic's geometries: a gradient, one to three rectangles of the caption's
colour, and uniform noise in [0, 16). The geometries are dealt in turn
(record i takes geometry i mod G), so every seed gives the same number of
images of each geometry, in the same order; only the content moves.
Captions and rectangles come from ``numpy.random.default_rng``; the noise
from a ``torch.Generator`` on the device, in one call a geometry group.
"""

from __future__ import annotations

import numpy as np
import torch

COLORS = {
    "red": (220, 40, 40),
    "blue": (40, 60, 220),
    "green": (40, 200, 80),
    "yellow": (230, 220, 50),
    "black": (20, 20, 20),
    "white": (240, 240, 240),
}
OBJECTS = ["dog", "cat", "car", "pizza", "chair", "laptop", "person", "bus", "clock", "bed"]
COUNTS = ["one", "two", "three", "several", "many"]
SPATIAL = ["on the left", "on the right", "above the table", "behind the fence", "near the window"]


def captions_for(color: str, obj: str, count: str, spatial: str) -> list[str]:
    return [
        f"{count} {color} {obj} {spatial}",
        f"a photo of a {color} {obj}",
        f"the {obj} is {spatial} in the picture",
        f"{count} {obj}s can be seen here",
        f"an image showing a {obj} with {color} tones",
    ]


def records(n: int, rng: np.random.Generator, first_id: int = 0) -> list[dict]:
    """``n`` records {'captions', 'color', 'imgid'}, drawn from ``rng``."""
    names = list(COLORS)
    out = []
    for i in range(n):
        color = names[int(rng.integers(len(names)))]
        obj = OBJECTS[int(rng.integers(len(OBJECTS)))]
        count = COUNTS[int(rng.integers(len(COUNTS)))]
        spatial = SPATIAL[int(rng.integers(len(SPATIAL)))]
        out.append({"captions": captions_for(color, obj, count, spatial), "color": color, "imgid": first_id + i})
    return out


def gradient(h: int, w: int, device) -> torch.Tensor:
    """int16 [3, h, w]: the synthetic images' colour gradient."""
    yy = torch.arange(h, device=device, dtype=torch.int32)[:, None].expand(h, w)
    xx = torch.arange(w, device=device, dtype=torch.int32)[None, :].expand(h, w)
    return torch.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1), (xx + yy) * 255 // max(h + w, 1)]).to(
        torch.int16)


def render(recs: list[dict], h: int, w: int, rng: np.random.Generator, gen: torch.Generator,
           device) -> torch.Tensor:
    """uint8 [len(recs), 3, h, w] (NCHW, as the port stages images): each
    record's image, its rectangles from ``rng`` and its noise from ``gen``."""
    x = gradient(h, w, device).expand(len(recs), 3, h, w).clone()
    for b, rec in enumerate(recs):
        color = torch.tensor(COLORS[rec["color"]], dtype=torch.int16, device=device)[:, None, None]
        for _ in range(int(rng.integers(1, 4))):
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            dy, dx = int(rng.integers(h // 8, h // 2)), int(rng.integers(w // 8, w // 2))
            x[b, :, y0 : y0 + dy, x0 : x0 + dx] = color
    x += torch.randint(0, 16, x.shape, generator=gen, device=device, dtype=torch.int16)
    return x.clamp_(0, 255).to(torch.uint8)
