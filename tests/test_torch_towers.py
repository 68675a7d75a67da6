"""The port's towers against the JAX package's at the debug config, f32, CPU.

Weights are drawn by the JAX package and carried into the port's modules by
``params_from_jax``; inputs are made with numpy. Tolerance 1e-4 absolute
(f32 sums in another order through a few layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models import towers as jtowers
from multimodal_embedding_tpu.models.zoo import debug_dual_config as jax_debug_config
from multimodal_embedding_tpu_torch.models import layers as tlayers
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config
from multimodal_embedding_tpu_torch.ops.activation_cuda import ACTIVATIONS
from tests.torch_impls import impl  # noqa: F401  (the parametrized attention switch)

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_jax_cfg(cfg):
    return jtowers.DualEncoderConfig(
        vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jtowers.TextConfig(**dataclasses.asdict(cfg.text)),
        family=cfg.family,
    )


def _pair(cfg, seed=0):
    jparams = jtowers.dual_encoder_init(jax.random.key(seed), _as_jax_cfg(cfg))
    model = DualEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jparams), device="cpu"))
    return jparams, model


def test_debug_config_matches_jax():
    cfg = debug_dual_config("dense")
    assert _as_jax_cfg(cfg) == jax_debug_config("dense")


def test_params_from_jax_covers_every_weight():
    cfg = debug_dual_config("dense")
    jparams = jtowers.dual_encoder_init(jax.random.key(0), _as_jax_cfg(cfg))
    state = params_from_jax(_np_tree(jparams), dtype=torch.bfloat16, device="cpu")
    model = DualEncoder(cfg, device="cpu", dtype=torch.bfloat16)
    assert set(state) == set(model.state_dict())
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    w = np.asarray(jparams["vision"]["encoder"]["attn"]["q"]["w"][1])
    np.testing.assert_array_equal(state["vision.encoder.layers.1.attn.q.w"].float().numpy(),
                                  w.astype(jnp.bfloat16).astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_encoder_layers_match_jax(impl, causal, masked):
    cfg = debug_dual_config("dense").text
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, cfg.dim)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(19)[None, :] < np.array([[19], [7]])).astype(np.int32)
    stacked = jlayers.encoder_stack_init(jax.random.key(1), cfg.layers, cfg.dim, cfg.mlp_dim)
    jm = None if mask is None else jnp.asarray(mask)
    want_one = jlayers.encoder_layer(jax.tree.map(lambda a: a[0], stacked), jnp.asarray(x), cfg.heads,
                                     cfg.act, causal=causal, mask=jm)
    want = jlayers.encoder_stack(stacked, jnp.asarray(x), cfg.heads, cfg.act, causal=causal, mask=jm)

    holder = torch.nn.Module()
    holder.encoder = tlayers.Encoder(cfg.layers, cfg.dim, cfg.heads, cfg.mlp_dim, cfg.act, cfg.ln_eps,
                                     gen=torch.Generator(), device="cpu", dtype=torch.float32)
    holder.load_state_dict(params_from_jax({"encoder": _np_tree(stacked)}, device="cpu"))
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got_one = holder.encoder.layers[0](torch.from_numpy(x), causal=causal, mask=tm)
        got = holder.encoder(torch.from_numpy(x), causal=causal, mask=tm)
    np.testing.assert_allclose(got_one.numpy(), np.asarray(want_one), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
def test_vision_tower_matches_jax(impl):
    cfg = debug_dual_config("dense")
    jparams, model = _pair(cfg)
    px = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = jtowers.encode_image(jparams, _as_jax_cfg(cfg), jnp.asarray(px))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(px))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _ids(cfg, eos, rng, lengths):
    ids = np.zeros((len(lengths), cfg.text.max_len), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, cfg.text.vocab_size - 2, n)
        ids[i, n - 1] = eos
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("impl", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("eos_rule", ["first-occurrence", "argmax"])
def test_text_tower_matches_jax(impl, eos_rule):
    cfg = debug_dual_config("dense")
    if eos_rule == "argmax":  # legacy configs: eos_token_id == 2 pools at argmax(ids)
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=2))
        eos = cfg.text.vocab_size - 1
    else:
        eos = cfg.text.eos_token_id
    jparams, model = _pair(cfg, seed=3)
    ids, mask = _ids(cfg, eos, np.random.default_rng(2), [5, 64, 17])
    want = jtowers.encode_text(jparams, _as_jax_cfg(cfg), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu", "gelu_pytorch_tanh"])
def test_activations_and_norms_match_jax(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32)).astype(np.float32) * 3
    np.testing.assert_allclose(ACTIVATIONS[act](torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.ACTIVATIONS[act](jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    scale, bias = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)).numpy(),
        np.asarray(jlayers.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(x))), atol=1e-5, rtol=0)
    w, b = rng.standard_normal((32, 8)).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jlayers.linear({"w": w, "b": b}, jnp.asarray(x))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlayers.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.l2_normalize(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_siglip_style_is_not_yet_ported():
    """The siglip style builds with its MAP head and text head (their parity
    with the JAX package: tests/test_torch_siglip.py); a tower style that
    neither package has is refused."""
    model = DualEncoder(debug_dual_config("siglip"), device="cpu")
    assert hasattr(model.vision, "head") and hasattr(model.text, "head")
    cfg = debug_dual_config("dense")
    for tower in ("vision", "text"):
        bad = dataclasses.replace(cfg, **{tower: dataclasses.replace(getattr(cfg, tower), style="eva")})
        with pytest.raises(ValueError):
            DualEncoder(bad, device="cpu")
