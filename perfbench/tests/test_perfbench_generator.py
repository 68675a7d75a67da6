"""The generator is deterministic by seed, and the harness lays out its
device caches as the port's ``stage_images`` does."""

from __future__ import annotations

import numpy as np
import torch

from multimodal_embedding_tpu_torch.models.encode import stage_images
from perfbench import generator
from perfbench.drivers.encode import device_cache, raw_image

GEOMS = [[24, 32], [32, 24], [20, 20]]


def _cache(seed: int, n: int = 11, batch: int = 4):
    rng = np.random.default_rng([seed, 2])
    gen = torch.Generator().manual_seed(seed)
    recs = generator.records(n, rng)
    return recs, device_cache(recs, GEOMS, batch, rng, gen, "cpu")


def test_same_seed_same_inputs():
    (ra, ca), (rb, cb), (rc, cc) = _cache(3), _cache(3), _cache(4)
    assert ra == rb and ra != rc
    for ga, gb, gc in zip(ca.groups, cb.groups, cc.groups):
        assert torch.equal(ga[2], gb[2]) and not torch.equal(ga[2], gc[2])


def test_geometries_dealt_in_turn():
    _, cache = _cache(5, n=12)
    assert [g[0] for g in cache.groups] == [tuple(g) for g in GEOMS]
    assert [g[3] for g in cache.groups] == [4, 4, 4]


def test_layout_equals_stage_images():
    recs, cache = _cache(7)
    images = [raw_image(cache, i).permute(1, 2, 0).numpy() for i in range(len(recs))]
    staged = stage_images(images, cache.batch_size, "cpu")
    assert staged.n_images == cache.n_images and staged.batch_size == cache.batch_size
    for (g1, i1, d1, c1), (g2, i2, d2, c2) in zip(staged.groups, cache.groups):
        assert (g1, i1, c1) == (tuple(g2), i2, c2)
        assert torch.equal(d1, d2)
