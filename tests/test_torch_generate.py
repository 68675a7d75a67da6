"""The port's generation, Gemma's KV-cache steps and the LoRA merge against
the JAX package's, on the CPU.

Weights are the JAX inits at the debug configs of ``cli/train_rl.py`` (4/2
heads, Dh 16, the byte tokenizer's 259 ids), carried into the port by
``params_from_jax``; prompts are byte-tokenized and left-padded. f32
throughout.

- Greedy ``generate`` (``max_new`` 8) gives JAX ``rl.generate.generate``'s
  tokens exactly, for Qwen3 and Gemma; the logps agree to atol 1e-4.
- ``gemma_prefill`` and three ``gemma_decode_step``s: hidden states at valid
  positions, every step's logits (atol 1e-4), and the KV cache at its valid
  slots (atol 1e-5).
- Sampling draws from a ``torch.Generator``, so its tokens are not JAX's:
  each logp is the log-softmax of the unscaled logits at the sampled token
  (held against a full causal forward over prompt + completion, atol 1e-4),
  at temperature 0.7; temperature 1e-6 gives the greedy tokens.
- ``lora_merge`` against JAX's on the same adapters (``b`` nonzero): merged
  q/k/v/o within 1e-6, every other tensor shared with the base.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.cli.train_rl import default_gemma_config, default_qwen3_config
from multimodal_embedding_tpu.models import gemma as jg
from multimodal_embedding_tpu.rl import lora as jlora
from multimodal_embedding_tpu.rl import policy as jpolicy
from multimodal_embedding_tpu.rl import tokenizer as jtok
from multimodal_embedding_tpu.rl.generate import generate as jax_generate
from multimodal_embedding_tpu_torch.rl import lora as tlora
from multimodal_embedding_tpu_torch.rl import policy as tpolicy
from multimodal_embedding_tpu_torch.rl.generate import generate
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 1e-4
KV_ATOL = 1e-5
MAX_NEW = 8
TEXTS = ["Ticket #3: where is my package", "hi", "the app keeps crashing with an error"]


def _model(arch: str, seed: int = 0):
    """(JAX arch, JAX config, JAX params, port module) on the same weights."""
    cfg = default_qwen3_config("debug") if arch == "qwen3" else default_gemma_config("debug")
    jarch = jpolicy.get_arch(arch)
    params = jarch.init(jax.random.key(seed), cfg)
    tarch = tpolicy.get_arch(arch)
    tcfg = tarch.config(**cfg.__dict__)
    model = tarch.from_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jarch, cfg, params, model


def _prompts():
    return jtok.pad_left([jtok.encode(t) for t in TEXTS])


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_greedy_tokens_equal_jax(arch):
    jarch, cfg, params, model = _model(arch)
    ids, mask = _prompts()
    jt, jl = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0),
                          max_new=MAX_NEW, greedy=True, arch=jarch)
    tt, tl = generate(model, torch.from_numpy(ids), torch.from_numpy(mask), MAX_NEW, greedy=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tt.dtype == torch.int32 and tl.dtype == torch.float32


def test_gemma_prefill_and_decode_steps_match_jax():
    _, cfg, params, model = _model("gemma", seed=3)
    ids, mask = _prompts()
    b, tp = ids.shape
    steps, cache_len = 3, tp + 3
    jh, jkv = jg.gemma_prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask), cache_len)
    with torch.no_grad():
        th, tkv = model.prefill(torch.from_numpy(ids), torch.from_numpy(mask), cache_len)
        tfirst = model.lm_logits(th[:, -1:])
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tfirst.numpy(), np.asarray(jg.gemma_lm_logits(params, cfg, jh[:, -1:])),
                               rtol=RTOL, atol=ATOL)
    rng = np.random.default_rng(4)
    prompt_len = mask.sum(-1)
    for i in range(steps):
        tok = rng.integers(3, cfg.vocab_size, size=b).astype(np.int32)
        pos = (prompt_len + i).astype(np.int32)
        cache_valid = np.concatenate([valid, np.broadcast_to(np.arange(steps) <= i, (b, steps))], axis=1)
        jlog, jkv = jg.gemma_decode_step(params, cfg, jkv, jnp.asarray(tok), jnp.asarray(pos), tp + i,
                                         jnp.asarray(cache_valid))
        with torch.no_grad():
            tlog, tkv = model.decode_step(tkv, torch.from_numpy(tok), torch.from_numpy(pos), tp + i,
                                          torch.from_numpy(cache_valid))
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=RTOL, atol=ATOL)
    slots = np.concatenate([valid, np.ones((b, steps), bool)], axis=1)
    for name in ("k", "v"):
        got = tkv[name].numpy().transpose(0, 1, 3, 2, 4)  # port [L, B, KVH, S, Dh] -> JAX [L, B, S, KVH, Dh]
        np.testing.assert_allclose(got[:, slots], np.asarray(jkv[name])[:, slots], rtol=0, atol=KV_ATOL)


def test_sampled_logps_are_unscaled_and_tiny_temperature_is_greedy():
    _, _, _, model = _model("qwen3", seed=1)
    ids, mask = (torch.from_numpy(x) for x in _prompts())
    greedy, _ = generate(model, ids, mask, MAX_NEW, greedy=True)
    cold, _ = generate(model, ids, mask, MAX_NEW, temperature=1e-6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(cold, greedy)
    toks, logps = generate(model, ids, mask, MAX_NEW, temperature=0.7, generator=torch.Generator().manual_seed(1))
    again, _ = generate(model, ids, mask, MAX_NEW, temperature=0.7, generator=torch.Generator().manual_seed(1))
    assert torch.equal(toks, again)  # reproducible from the generator's seed
    # a full causal forward over prompt + completion: the logits before each token
    full_ids = torch.cat([ids, toks], dim=1)
    full_mask = torch.cat([mask, torch.ones_like(toks)], dim=1)
    with torch.no_grad():
        logits = model.lm_logits(model(model.embed_tokens(full_ids), full_mask))
    tp = ids.shape[1]
    want = torch.log_softmax(logits[:, tp - 1 : -1], dim=-1).gather(-1, toks.long()[..., None])[..., 0]
    np.testing.assert_allclose(logps.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_lora_merge_matches_jax(arch):
    _, cfg, params, model = _model(arch, seed=2)
    lcfg = jlora.LoraConfig(rank=4, alpha=8)
    adapters = jlora.lora_init(jax.random.key(5), params, lcfg)
    for i, name in enumerate(lcfg.targets):  # a nonzero b, so the merge is not the identity
        adapters[name]["b"] = 0.02 * jax.random.normal(jax.random.key(10 + i), adapters[name]["b"].shape)
    merged_j = jlora.lora_merge(params, adapters, lcfg)
    np_adapters = jax.tree.map(np.asarray, adapters)
    merged = tlora.lora_merge(model, np_adapters, tlora.LoraConfig(rank=4, alpha=8))
    assert type(merged) is type(model)
    base_state, state = model.state_dict(), merged.state_dict()
    for i in range(cfg.layers):
        for name in lcfg.targets:
            key = f"layers.{i}.attn.{name}"
            np.testing.assert_allclose(state[key].numpy(), np.asarray(merged_j["layers"]["attn"][name][i]),
                                       rtol=0, atol=1e-6)
            assert not torch.equal(state[key], base_state[key])
    for key, t in state.items():
        if key.split(".")[-1] not in lcfg.targets:
            assert t.data_ptr() == base_state[key].data_ptr(), key  # shared, not copied
    # the port's init: a normal / r and b zeros, so its merge is the identity
    init = tlora.lora_init(model, tlora.LoraConfig(rank=4, alpha=8), generator=torch.Generator().manual_seed(0))
    assert init["q"]["a"].shape == (cfg.layers, cfg.dim, 4) and not init["q"]["b"].any()
    same = tlora.lora_merge(model, init, tlora.LoraConfig(rank=4, alpha=8)).state_dict()
    assert all(torch.equal(same[k], base_state[k]) for k in base_state)
