"""The port's siglip pieces against the JAX package's, at the debug config,
f32, CPU: cross attention (``MultiHeadAttention`` with ``kv=``), the MAP
attention-pooling head, the bidirectional text tower with a key mask, and the
full-architecture configs of every model.

Weights are drawn by the JAX package and carried into the port's modules by
``params_from_jax``; inputs are made with numpy. Tolerance 1e-4 absolute
(f32 sums in another order through a few layers), as in
``tests/test_torch_towers.py``. The port's ``pallas`` impl is, on the CPU,
the attention kernel's plain version (finite masking).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import arch as jarch
from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models import towers as jtowers
from multimodal_embedding_tpu_torch.models import arch as tarch
from multimodal_embedding_tpu_torch.models import layers as tlayers
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_jax_cfg(cfg):
    return jtowers.DualEncoderConfig(
        vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jtowers.TextConfig(**dataclasses.asdict(cfg.text)),
        family=cfg.family,
    )


@pytest.fixture
def impl(request):
    jlayers.set_attention_impl(request.param)
    tlayers.set_attention_impl(request.param)
    yield request.param
    jlayers.set_attention_impl("auto")
    tlayers.set_attention_impl("auto")


def _pair(cfg, seed=0):
    jparams = jtowers.dual_encoder_init(jax.random.key(seed), _as_jax_cfg(cfg))
    model = DualEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jparams), device="cpu"))
    return jparams, model


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("tq,tk,masked", [(1, 19, False), (5, 19, True)])
def test_cross_attention_matches_jax(impl, tq, tk, masked):
    d, heads = 32, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, tq, d)).astype(np.float32)
    kv = rng.standard_normal((2, tk, d)).astype(np.float32)
    mask = (np.arange(tk)[None, :] < np.array([[tk], [6]])).astype(np.int32) if masked else None
    jp = {n: jlayers.linear_init(k, d, d) for n, k in zip("qkvo", jax.random.split(jax.random.key(1), 4))}
    want = jlayers.mha(jp, jnp.asarray(x), heads, kv=jnp.asarray(kv),
                       mask=None if mask is None else jnp.asarray(mask))
    holder = torch.nn.Module()
    holder.attn = tlayers.MultiHeadAttention(d, heads, gen=torch.Generator(), device="cpu", dtype=torch.float32)
    holder.load_state_dict(params_from_jax({"attn": _np_tree(jp)}, device="cpu"))
    with torch.no_grad():
        got = holder.attn(torch.from_numpy(x), kv=torch.from_numpy(kv),
                          mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, tq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_siglip_params_cover_every_weight():
    cfg = debug_dual_config("siglip")
    jparams = jtowers.dual_encoder_init(jax.random.key(0), _as_jax_cfg(cfg))
    state = params_from_jax(_np_tree(jparams), device="cpu")
    model = DualEncoder(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    assert {"vision.head.probe", "vision.head.attn.q.w", "vision.head.mlp.fc2.b", "text.head.w"} <= set(state)
    assert "vision.proj" not in state  # proj_dim None: the pooled row is the embedding


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("proj_dim", [None, 24])
def test_siglip_vision_tower_with_map_head_matches_jax(impl, proj_dim):
    cfg = debug_dual_config("siglip")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, proj_dim=proj_dim))
    jparams, model = _pair(cfg, seed=1)
    px = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = jtowers.encode_image(jparams, _as_jax_cfg(cfg), jnp.asarray(px))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(px))
    assert got.dtype == torch.float32 and got.shape == (3, proj_dim or cfg.vision.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_siglip_text_tower_with_key_mask_matches_jax(impl):
    cfg = debug_dual_config("siglip")
    jparams, model = _pair(cfg, seed=3)
    rng = np.random.default_rng(2)
    lengths = [5, 64, 17]
    ids = np.zeros((3, cfg.text.max_len), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, cfg.text.vocab_size - 1, n)
        mask[i, :n] = 1
    want = jtowers.encode_text(jparams, _as_jax_cfg(cfg), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # pooled at the last position, a pad key for the short rows: the key mask
    # must reach it (without the mask the short rows change)
    with torch.no_grad():
        unmasked = model.encode_text(torch.from_numpy(ids).long(), None)
    assert not np.allclose(unmasked[0].numpy(), got[0].numpy(), atol=ATOL)


def test_full_arch_configs_match_jax():
    assert set(tarch.FULL_ARCH_CONFIGS) == set(jarch.FULL_ARCH_CONFIGS)
    for name, cfg in tarch.FULL_ARCH_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jarch.FULL_ARCH_CONFIGS[name]), name
    assert dataclasses.asdict(tarch.full_jina_config()) == dataclasses.asdict(jarch.full_jina_config())
    assert dataclasses.asdict(tarch.full_colpali_config()) == dataclasses.asdict(jarch.full_colpali_config())
