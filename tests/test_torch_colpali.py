"""The port's ColPali modules against the JAX package's, at the debug
config, in f32 on the CPU.

Weights are drawn by the JAX package (``colpali_init``) and carried into the
port's ``ColPali`` by ``params_from_jax``; inputs are made with numpy. Each
of ``rms_norm``, ``_rope``, ``grouped_attention`` (multi-query, right- and
left-padded key masks, causal and not), ``gemma_apply``, the headless siglip
tower, ``colpali_image_fwd`` and ``colpali_text_fwd`` is held against its JAX
function at 1e-4 absolute (f32 sums in another order through a few layers),
with the port's and the JAX package's attention both set to "xla" and both
to "pallas" (the kernel's plain version; the JAX kernel in interpret mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import colpali as jcolpali
from multimodal_embedding_tpu.models import decoder_attn as jdecoder_attn
from multimodal_embedding_tpu.models import gemma as jgemma
from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models import towers as jtowers
from multimodal_embedding_tpu.models.arch import full_colpali_config as jax_full_colpali_config
from multimodal_embedding_tpu_torch.models import gemma as tgemma
from multimodal_embedding_tpu_torch.models.arch import full_colpali_config
from multimodal_embedding_tpu_torch.models.colpali import ColPali, debug_colpali_config
from multimodal_embedding_tpu_torch.models.decoder_attn import grouped_attention
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from tests.torch_impls import impl  # noqa: F401  (the parametrized attention switch)

ATOL = 1e-4
SUFFIX = np.array([1, 7, 8, 9], np.int32)


def _as_jax_cfg(cfg):
    return jcolpali.ColPaliConfig(
        vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
        gemma=jgemma.GemmaConfig(**dataclasses.asdict(cfg.gemma)),
        embedding_dim=cfg.embedding_dim,
        image_token_id=cfg.image_token_id,
    )


@pytest.fixture(scope="module")
def pair():
    cfg = debug_colpali_config()
    jcfg = _as_jax_cfg(cfg)
    jparams = jcolpali.colpali_init(jax.random.key(0), jcfg, SUFFIX)
    model = ColPali(cfg, SUFFIX, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return cfg, jcfg, jparams, model


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _masks(b, t):
    """Full, right-padded and left-padded rows."""
    m = np.ones((b, t), np.int32)
    m[1, t // 2 :] = 0
    m[2, : t // 3] = 0
    return m


def test_configs_match_jax():
    assert _as_jax_cfg(debug_colpali_config()) == jcolpali.debug_colpali_config()
    assert _as_jax_cfg(full_colpali_config()) == jax_full_colpali_config()


def test_params_from_jax_covers_every_weight(pair):
    cfg, _, jparams, model = pair
    state = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.bfloat16, device="cpu")
    assert set(state) == set(model.state_dict())
    assert state["image_suffix_ids"].dtype == torch.int32
    np.testing.assert_array_equal(state["image_suffix_ids"].numpy(), SUFFIX)
    assert all(v.dtype == torch.bfloat16 for k, v in state.items() if k != "image_suffix_ids")
    w = np.asarray(jparams["gemma"]["layers"]["mlp"]["up"][1])
    np.testing.assert_array_equal(state["gemma.layers.1.mlp.up"].float().numpy(),
                                  np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)))
    assert "vision.encoder.layers.1.attn.q.w" in state and "vision.patch.b" in state


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32) * 0.1
    _close(tgemma.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-6),
           jgemma.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6))
    xr = rng.standard_normal((3, 9, 4, 16)).astype(np.float32)
    pos = np.cumsum(_masks(3, 9), axis=-1) - 1  # left padding gives negative positions
    _close(tgemma._rope(torch.from_numpy(xr), torch.from_numpy(pos), 10000.0),
           jgemma._rope(jnp.asarray(xr), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_heads", [1, 2])
def test_grouped_attention_matches_jax(impl, causal, kv_heads):
    rng = np.random.default_rng(1)
    b, t, h, dh = 3, 11, 4, 16
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv_heads, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv_heads, dh)).astype(np.float32)
    km = _masks(b, t)
    if causal:
        km[2] = 1  # left padding with a causal mask would leave rows with no valid key
    want = jdecoder_attn.grouped_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           key_mask=jnp.asarray(km > 0), causal=causal, sm_scale=0.25)
    got = grouped_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            key_mask=torch.from_numpy(km > 0), causal=causal, sm_scale=0.25)
    assert got.shape == (b, t, h * dh)
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_gemma_apply_matches_jax(impl, pair):
    cfg, jcfg, jparams, model = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, cfg.gemma.dim)).astype(np.float32)
    mask = _masks(3, 10)
    with torch.no_grad():
        _close(model.gemma(torch.from_numpy(x), attn_mask=torch.from_numpy(mask)),
               jgemma.gemma_apply(jparams["gemma"], jcfg.gemma, jnp.asarray(x), attn_mask=jnp.asarray(mask)))
        _close(model.gemma(torch.from_numpy(x)), jgemma.gemma_apply(jparams["gemma"], jcfg.gemma, jnp.asarray(x)))
        ids = rng.integers(0, cfg.gemma.vocab_size, (2, 5))
        _close(model.gemma.embed_tokens(torch.from_numpy(ids)),
               jgemma.gemma_embed(jparams["gemma"], jcfg.gemma, jnp.asarray(ids)))


def test_gemma_embed_rounds_the_scale_to_the_embedding_dtype():
    cfg = tgemma.GemmaConfig(vocab_size=4, dim=2048, layers=0, heads=8, kv_heads=1, head_dim=256, mlp_dim=8)
    model = tgemma.Gemma(cfg, gen=torch.Generator(), device="cpu", dtype=torch.bfloat16)
    model.embed.data.fill_(1.0)
    assert float(model.embed_tokens(torch.tensor([[0]]))[0, 0, 0]) == 45.25


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_headless_siglip_tower_matches_jax(impl, pair):
    cfg, jcfg, jparams, model = pair
    px = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.vision(torch.from_numpy(px))
    assert got.shape == (2, cfg.vision.n_patches, cfg.vision.dim)
    _close(got, jtowers.vision_tower_apply(jparams["vision"], jcfg.vision, jnp.asarray(px)))


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_colpali_image_fwd_matches_jax(impl, pair):
    cfg, jcfg, jparams, model = pair
    px = np.random.default_rng(4).standard_normal((3, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.image_fwd(torch.from_numpy(px))
    assert got.shape == (3, cfg.vision.n_patches + len(SUFFIX), cfg.embedding_dim)
    _close(got, jcolpali.colpali_image_fwd(jparams, jcfg, jnp.asarray(px)))


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_colpali_text_fwd_matches_jax_with_zero_pads(impl, pair):
    cfg, jcfg, jparams, model = pair
    rng = np.random.default_rng(5)
    ids = rng.integers(2, cfg.gemma.vocab_size - 1, (3, 12)).astype(np.int32)
    mask = _masks(3, 12)
    ids[mask == 0] = 0
    with torch.no_grad():
        got = model.text_fwd(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, jcolpali.colpali_text_fwd(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    assert bool((got[torch.from_numpy(mask) == 0] == 0).all())
    norms = torch.linalg.vector_norm(got[torch.from_numpy(mask) == 1], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)
