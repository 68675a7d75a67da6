"""The port's Qwen3 decoder against the JAX package's and HF's, on the CPU.

Weights are drawn by the JAX package's ``qwen3_init`` (or converted from a
random-weight HF ``Qwen3ForCausalLM`` built here from a config object,
offline) and carried into the port by ``params_from_jax``; inputs are made
from a seeded numpy generator, left-padded. f32 throughout.

- ``qwen3_apply`` hidden states and ``qwen3_lm_logits``, at valid positions
  (pad rows see only pad keys, where each implementation keeps its own
  uniform softmax): atol 1e-4, rtol 1e-4, at the debug config (4/2 heads, Dh
  16, tied head; ``cli/train_rl.py``) and a small untied one.
- ``qwen3_prefill`` plus three ``qwen3_decode_step``s: every step's logits
  (atol 1e-4) and the KV cache at its valid slots (atol 1e-5).
- HF: logits at valid positions (rtol 2e-4, atol 2e-5, as
  ``tests/test_qwen3_parity.py``) and greedy generation token for token equal
  to HF ``generate``.
- ``qwen3_params_from_hf`` gives the JAX converter's tree (tolerance 0), and
  the module builds on ``meta`` with the JAX init's names and shapes.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import qwen3 as jq
from multimodal_embedding_tpu_torch.models import qwen3 as tq
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.rl.generate import generate
from tests.test_torch_convert import assert_same_tree
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 1e-4
KV_ATOL = 1e-5

DEBUG = dict(vocab_size=259, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16, mlp_dim=128, tie_embeddings=True)
SMALL_UNTIED = dict(vocab_size=300, dim=96, layers=3, heads=6, kv_heads=2, head_dim=16, mlp_dim=160,
                    tie_embeddings=False)


def _pair(kw: dict, seed: int = 0):
    """(JAX config, JAX params, port config, port module) on the same weights."""
    jcfg = jq.Qwen3Config(**kw)
    params = jq.qwen3_init(jax.random.key(seed), jcfg)
    tcfg = tq.Qwen3Config(**kw)
    model = tq.qwen3_from_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _prompts(vocab: int, b: int = 3, t: int = 12, seed: int = 0):
    """Left-padded ids and mask: row 0 has 4 pads, row 1 has 9, the rest none."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for row, pads in ((0, 4), (1, 9)):
        mask[row, :pads] = 0
        ids[row, :pads] = 0
    return ids, mask


@pytest.mark.parametrize("kw", [DEBUG, SMALL_UNTIED], ids=["debug", "small-untied"])
def test_apply_and_logits_match_jax(kw):
    jcfg, params, _, model = _pair(kw)
    ids, mask = _prompts(kw["vocab_size"])
    jh = jq.qwen3_apply(params, jcfg, jq.qwen3_embed(params, jcfg, jnp.asarray(ids)), jnp.asarray(mask))
    jl = np.asarray(jq.qwen3_lm_logits(params, jcfg, jh))
    with torch.no_grad():
        th = model(model.embed_tokens(torch.from_numpy(ids)), torch.from_numpy(mask))
        tl = model.lm_logits(th)
    valid = mask.astype(bool)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy()[valid], jl[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [DEBUG, SMALL_UNTIED], ids=["debug", "small-untied"])
def test_prefill_and_decode_steps_match_jax(kw):
    """Prefill, then three decode steps fed the same tokens; the port's cache
    is [L, B, KVH, S, Dh], JAX's [L, B, S, KVH, Dh]."""
    jcfg, params, _, model = _pair(kw, seed=1)
    ids, mask = _prompts(kw["vocab_size"], seed=1)
    b, tp = ids.shape
    steps, cache_len = 3, tp + 3
    jh, jkv = jq.qwen3_prefill(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), cache_len)
    with torch.no_grad():
        th, tkv = model.prefill(torch.from_numpy(ids), torch.from_numpy(mask), cache_len)
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], rtol=RTOL, atol=ATOL)
    rng = np.random.default_rng(2)
    prompt_len = mask.sum(-1)
    for i in range(steps):
        tok = rng.integers(3, kw["vocab_size"], size=b).astype(np.int32)
        pos = (prompt_len + i).astype(np.int32)
        cache_valid = np.concatenate([valid, np.broadcast_to(np.arange(steps) <= i, (b, steps))], axis=1)
        jlog, jkv = jq.qwen3_decode_step(params, jcfg, jkv, jnp.asarray(tok), jnp.asarray(pos), tp + i,
                                         jnp.asarray(cache_valid))
        with torch.no_grad():
            tlog, tkv = model.decode_step(tkv, torch.from_numpy(tok), torch.from_numpy(pos), tp + i,
                                          torch.from_numpy(cache_valid))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=RTOL, atol=ATOL)
    slots = np.concatenate([valid, np.ones((b, steps), bool)], axis=1)  # [B, S]
    for name in ("k", "v"):
        got = tkv[name].numpy().transpose(0, 1, 3, 2, 4)  # -> [L, B, S, KVH, Dh]
        want = np.asarray(jkv[name])
        np.testing.assert_allclose(got[:, slots], want[:, slots], rtol=0, atol=KV_ATOL)


def _hf_model(seed: int, *, tie: bool, vocab: int = 256):
    from transformers import Qwen3Config as HFQwen3Config, Qwen3ForCausalLM

    hf_cfg = HFQwen3Config(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=1e6,
        rms_norm_eps=1e-6, tie_word_embeddings=tie, attn_implementation="eager",
    )
    torch.manual_seed(seed)
    return Qwen3ForCausalLM(hf_cfg).eval(), hf_cfg


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_logits_and_greedy_generation_match_hf(tie):
    hf, hf_cfg = _hf_model(5, tie=tie)
    cfg = tq.qwen3_config_from_hf(hf_cfg)
    assert cfg.tie_embeddings == tie
    model = tq.qwen3_from_params(tq.qwen3_params_from_hf(hf.state_dict(), cfg), cfg, device="cpu")
    ids, mask = _prompts(256, b=2, t=10, seed=5)
    ids64, mask64 = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask.astype(np.int64))
    with torch.no_grad():
        ref = hf(input_ids=ids64, attention_mask=mask64,
                 position_ids=(mask64.cumsum(-1) - 1).clamp_min(0)).logits.numpy()
        ours = model.lm_logits(model(model.embed_tokens(ids64), mask64)).numpy()
        out = hf.generate(input_ids=ids64, attention_mask=mask64, max_new_tokens=6, do_sample=False,
                          pad_token_id=0)
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], ref[valid], rtol=2e-4, atol=2e-5)
    toks, logps = generate(model, ids64, mask64, 6, greedy=True)
    np.testing.assert_array_equal(toks.numpy(), out[:, 10:].numpy())
    assert toks.dtype == torch.int32 and bool((logps <= 0).all())
    del hf
    gc.collect()


def test_hf_converter_matches_jax_and_builds_on_meta():
    hf, hf_cfg = _hf_model(1, tie=False, vocab=128)
    tcfg, jcfg = tq.qwen3_config_from_hf(hf_cfg), jq.qwen3_config_from_hf(hf_cfg)
    assert tcfg.__dict__ == jcfg.__dict__
    sd = hf.state_dict()
    tree = tq.qwen3_params_from_hf(sd, tcfg)
    assert_same_tree(tree, jq.qwen3_params_from_hf(sd, jcfg))
    # the module's names and shapes are the JAX init's, unrolled
    init = jax.tree.map(np.asarray, jq.qwen3_init(jax.random.key(0), jcfg))
    want = {k: tuple(v.shape) for k, v in params_from_jax(init, device="cpu").items()}
    meta = tq.Qwen3(tcfg, gen=None, device="meta", dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == want
    assert all(v.is_meta and v.dtype == torch.bfloat16 for v in meta.state_dict().values())
    del hf
    gc.collect()


def test_qwen3_14b_config_and_rms_norm_rounding():
    """QWEN3_14B is the JAX package's; the norm matches JAX's to 1e-6 in f32
    and bit for bit in bf16, where it rounds before its gain (HF
    Qwen3RMSNorm)."""
    assert tq.QWEN3_14B.__dict__ == jq.QWEN3_14B.__dict__
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.qwen3_rms_norm(torch.from_numpy(w).to(dtype), torch.from_numpy(x).to(dtype), 1e-6)
        want = jq.qwen3_rms_norm(jnp.asarray(w, jdtype), jnp.asarray(x, jdtype), 1e-6)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=1e-6 if dtype == torch.float32 else 0)
