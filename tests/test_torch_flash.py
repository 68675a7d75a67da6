"""``--attention-impl flash`` in the port, on the CPU.

The JAX package's ``flash`` route (``models/layers.py:_flash_sdpa``) calls
jax's library Pallas TPU flash-attention kernel, which has no CPU path, so
the port's ``flash`` is held to the JAX package's ``xla`` attention on the
same inputs, to 1e-5 in f32 (f32 sums in another order): the port sends
unmasked self-attention to its fused attention kernel (on CPU tensors its
plain version) over the real T tokens, and every other call (a key mask,
cross attention) to the ``xla`` path, as the JAX route does. Whole debug
towers under ``flash`` are held to the JAX towers under ``xla`` the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu_torch import runtime
from multimodal_embedding_tpu_torch.models import layers as tlayers
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def impls():
    jlayers.set_attention_impl("xla")
    with runtime.using(attention="flash"):
        yield
    jlayers.set_attention_impl("auto")


@pytest.mark.parametrize("causal, masked, self_attn", [
    (False, False, True), (True, False, True), (True, True, True), (False, True, True), (False, False, False),
])
def test_attention_core_flash_matches_jax_xla(impls, monkeypatch, causal, masked, self_attn):
    rng = np.random.default_rng(0)
    b, tq, tk, h, dh = 2, 33, 33 if self_attn else 20, 4, 16
    q, k, v = (rng.standard_normal((b, t, h * dh)).astype(np.float32) for t in (tq, tk, tk))
    mask = None
    if masked:
        mask = np.ones((b, tk), bool)
        mask[1, tk - 7:] = False
    want = jlayers.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, causal=causal,
                                  mask=None if mask is None else jnp.asarray(mask), self_attn=self_attn)
    from multimodal_embedding_tpu_torch.ops import attention_cuda

    seen = []
    kernel = attention_cuda.fused_attention
    monkeypatch.setattr(attention_cuda, "fused_attention", lambda *a, **kw: (seen.append(kw), kernel(*a, **kw))[1])
    got = tlayers.attention_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, causal=causal,
                                 mask=None if mask is None else torch.from_numpy(mask), self_attn=self_attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the kernel route takes exactly the unmasked self-attention calls, with no key mask
    assert len(seen) == (1 if self_attn and not masked else 0)
    assert all(kw["key_mask"] is None and kw["causal"] == causal for kw in seen)


@pytest.mark.parametrize("name", ["OpenAI-CLIP-L", "SigLIP-400M"])
def test_debug_towers_under_flash_match_jax_xla(impls, name):
    (jinfo,) = jax_models(name, 8)
    (tinfo,) = get_models_to_test(name, 8)
    jmodel = jax_load_debug_model(jinfo, seed=3)
    tmodel = load_debug_model(tinfo, seed=3, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    rng = np.random.default_rng(1)
    size = jmodel.cfg.vision.image_size
    px = rng.standard_normal((3, size, size, 3)).astype(np.float32)
    ids, mask = jmodel.tokenize(["a red dog on a sofa", "two cats", "a very long caption about a kitchen"])
    want_img = np.asarray(jmodel.image_features(jnp.asarray(px)))
    want_txt = np.asarray(jmodel.text_features(jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got_img = tmodel.model.encode_image(torch.from_numpy(px))
        got_txt = tmodel.model.encode_text(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got_img.numpy(), want_img, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_txt.numpy(), want_txt, atol=1e-5, rtol=0)


def test_fused_layer_under_flash_matches_jax_xla(impls):
    """--layer-impl fused with flash: the stacked-QKV kernel route is the
    "pallas" impl's; flash takes attention_core on the three views."""
    jlayers.set_layer_impl("xla")
    try:
        (jinfo,) = jax_models("OpenAI-CLIP-L", 8)
        (tinfo,) = get_models_to_test("OpenAI-CLIP-L", 8)
        jmodel = jax_load_debug_model(jinfo, seed=4)
        tmodel = load_debug_model(tinfo, seed=4, device="cpu")
        tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
        px = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
        want = np.asarray(jmodel.image_features(jnp.asarray(px)))
        with runtime.using(layer="fused"), torch.inference_mode():
            got = tmodel.model.encode_image(torch.from_numpy(px))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    finally:
        jlayers.set_layer_impl("auto")
