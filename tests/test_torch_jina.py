"""The port's Jina-CLIP-v1 towers against the JAX package's, at the debug
config, f32, CPU: the rope tables, rope application and ALiBi slopes, the
EVA02 vision tower (with and without the head's bias) and JinaBERT (with and
without a key mask).

Weights are drawn by the JAX package and carried into the port's modules by
``params_from_jax``, which unrolls Jina's ``blocks`` stacks; inputs are made
with numpy. Tolerance 1e-4 absolute (f32 sums in another order through a few
layers), as in ``tests/test_torch_towers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import jina as jjina
from multimodal_embedding_tpu_torch.models import jina as tjina
from multimodal_embedding_tpu_torch.models.params import params_from_jax

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return tjina.JinaClipConfig(vision=tjina.Eva02Config(**cfg.vision.__dict__),
                                text=tjina.JinaBertConfig(**cfg.text.__dict__))


def test_debug_config_matches_jax():
    assert _port_cfg(jjina.debug_jina_config()) == tjina.debug_jina_config()


@pytest.mark.parametrize("grid,head_dim,pt_grid", [(2, 8, 16), (14, 64, 16), (16, 64, 16)])
def test_rope_tables_match_jax(grid, head_dim, pt_grid):
    cos, sin = tjina._vision_rope_2d(grid, head_dim, 10000.0, pt_grid)
    jcos, jsin = jjina._vision_rope_2d(grid, head_dim, 10000.0, pt_grid)
    assert cos.shape == (grid * grid, head_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    x = np.random.default_rng(0).standard_normal((2, grid * grid, 3, head_dim)).astype(np.float32)
    np.testing.assert_array_equal(tjina._rotate_half_interleaved(torch.from_numpy(x)).numpy(),
                                  np.asarray(jjina._rotate_half_interleaved(jnp.asarray(x))))
    np.testing.assert_allclose(tjina._apply_rope_2d(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(jjina._apply_rope_2d(jnp.asarray(x), jcos, jsin)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [4, 6, 8, 12, 16])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_array_equal(tjina.alibi_slopes(heads), jjina.alibi_slopes(heads))


def _pair(seed=0):
    cfg = jjina.debug_jina_config()
    kv, kt = jax.random.split(jax.random.key(seed))
    jparams = {"vision": jjina.eva02_init(kv, cfg.vision), "text": jjina.jina_bert_init(kt, cfg.text)}
    model = tjina.JinaClip(_port_cfg(cfg), device="cpu")
    state = params_from_jax(_np_tree(jparams), device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return cfg, jparams, model


def test_params_unroll_the_blocks_stacks():
    _, jparams, model = _pair()
    state = model.state_dict()
    w = np.asarray(jparams["text"]["blocks"]["mlp"]["gated"]["w"][1])
    np.testing.assert_array_equal(state["text.blocks.1.mlp.gated.w"].numpy(), w)
    w = np.asarray(jparams["vision"]["blocks"]["attn"]["k"]["w"][0])
    np.testing.assert_array_equal(state["vision.blocks.0.attn.k.w"].numpy(), w)


@pytest.mark.parametrize("proj_bias", [False, True])
def test_eva02_tower_matches_jax(proj_bias):
    cfg, jparams, model = _pair(seed=1)
    rng = np.random.default_rng(1)
    if proj_bias:
        b = rng.standard_normal(cfg.vision.proj_dim).astype(np.float32)
        jparams["vision"]["proj_b"] = jnp.asarray(b)
        model.vision.proj_b = torch.nn.Parameter(torch.from_numpy(b), requires_grad=False)
    px = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jjina.eva02_apply(jparams["vision"], cfg.vision, jnp.asarray(px))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(px))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.vision.proj_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_jina_bert_matches_jax(masked):
    cfg, jparams, model = _pair(seed=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.text.vocab_size, (3, 20)).astype(np.int32)
    mask = (np.arange(20)[None, :] < np.array([[20], [7], [1]])).astype(np.int32) if masked else None
    want = jjina.jina_bert_apply(jparams["text"], cfg.text, jnp.asarray(ids),
                                 None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(ids).long(), None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, cfg.text.proj_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
