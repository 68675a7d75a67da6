"""The port's GRPO trainer, LoRA gradient and optimizers against the JAX
package's, on the CPU.

Weights are the JAX inits at the debug configs of ``cli/train_rl.py`` (Qwen3
and Gemma: 2 layers, 4/2 heads, Dh 16, the byte tokenizer's 259 ids);
adapters are JAX's ``lora_init`` (rank 2, alpha 4) with ``b`` drawn nonzero.
Both go into the port as numpy arrays. f32 throughout.

- ``_completion_logps`` against JAX's: atol 1e-5. ``completion_token_mask``
  equals JAX's exactly.
- ``loss_and_grads`` against the JAX trainer's ``_grad_fn`` on fixed
  completions, advantages and ``ref_logps``: loss, pg and kl to rtol 1e-5,
  every adapter gradient to max|d| <= 1e-5 max|g| (sums in another order).
- Through ``apply_lora`` the gradient reaches the adapters and no base
  weight: at ``lora_init`` (``b`` = 0) ``a``'s gradient is exactly zero and
  ``b``'s is not, as in JAX.
- Two AdamW updates of the trainer (``grpo.ADAMW``) against the JAX
  trainer's ``optax.adamw``, and two Adam steps (``pretrain.ADAM``) against
  ``optax.adam``, on the same params and grads (lr 1e-2): rtol 1e-6, atol
  1e-6 (1e-4 of an update; the libraries round it in another order).
- ``save_state`` of one package loaded by the other's ``load_state``: the
  adapters bit-equal, and the next update equal to rtol 1e-6, atol 1e-6.
- The ``matmul_f32`` autograd Function (the card's bf16 branch) against plain
  autograd of ``x.float() @ w.float()``: output and grads max|d|/max|plain|
  1e-6 in f32, 1e-2 in bf16 (its output grad is rounded to bf16 once).
- Ports of ``tests/test_rl.py``'s ``test_grpo_smoke_training`` (and its
  Qwen3 twin) and ``test_grpo_surrogate_loss_descends`` on their configs and
  JAX-drawn weights. The smoke test's rollouts sample from a
  ``torch.Generator``, so it holds the behaviour, not the digits; the
  surrogate test runs on the JAX test's rollout and adapters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_embedding_tpu.cli.train_rl import default_gemma_config, default_qwen3_config
from multimodal_embedding_tpu.models.gemma import GemmaConfig, gemma_init
from multimodal_embedding_tpu.models.qwen3 import Qwen3Config, qwen3_init
from multimodal_embedding_tpu.rl import grpo as jgrpo
from multimodal_embedding_tpu.rl import lora as jlora
from multimodal_embedding_tpu.rl import policy as jpolicy
from multimodal_embedding_tpu.rl import tokenizer as jtok
from multimodal_embedding_tpu.rl.datasets import generate_support_tickets
from multimodal_embedding_tpu.rl.rewards import support_ticket_reward
from multimodal_embedding_tpu_torch.models import layers
from multimodal_embedding_tpu_torch.rl import grpo as tgrpo
from multimodal_embedding_tpu_torch.rl import lora as tlora
from multimodal_embedding_tpu_torch.rl import policy as tpolicy
from multimodal_embedding_tpu_torch.rl import pretrain as tpretrain
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOGP_ATOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
GRAD_REL = 1e-5  # max|d| / max|g| per adapter tensor
# 1e-4 of an update at lr 1e-2: the libraries round the update in another order
OPT_RTOL, OPT_ATOL = 1e-6, 1e-6
LORA = dict(rank=2, alpha=4)
TEXTS = ["Ticket #3: where is my package", "hi", "the app keeps crashing with an error", "refund please"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tree(tree) -> dict:
    """A JAX adapters tree (or grads) as torch tensors."""
    return {n: {p: _t(v) for p, v in ab.items()} for n, ab in tree.items()}


def _pair(arch: str, seed: int = 0):
    """(JAX arch, JAX config, JAX params, port module) on the same weights."""
    cfg = default_qwen3_config("debug") if arch == "qwen3" else default_gemma_config("debug")
    jarch = jpolicy.get_arch(arch)
    params = jarch.init(jax.random.key(seed), cfg)
    tarch = tpolicy.get_arch(arch)
    model = tarch.from_params(jax.tree.map(np.asarray, params), tarch.config(**cfg.__dict__), device="cpu")
    return jarch, cfg, params, model


def _adapters(params, seed: int = 1) -> dict:
    """JAX ``lora_init`` with ``b`` drawn nonzero, so the policy is not the base."""
    lcfg = jlora.LoraConfig(**LORA)
    adapters = jlora.lora_init(jax.random.key(seed), params, lcfg)
    for i, name in enumerate(lcfg.targets):
        adapters[name]["b"] = 0.05 * jax.random.normal(jax.random.key(20 + i), adapters[name]["b"].shape)
    return adapters


def _batch(vocab: int):
    """Left-padded prompts, fixed completions (two rows stop at an EOS) and
    advantages."""
    ids, mask = jtok.pad_left([jtok.encode(t) for t in TEXTS])
    comps = np.random.default_rng(0).integers(3, vocab, size=(len(TEXTS), 10)).astype(np.int32)
    comps[0, 4] = comps[2, 7] = jtok.EOS_ID
    adv = np.array([1.0, -1.0, 0.5, -0.5], np.float32)
    return ids, mask, comps, adv


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_completion_logps_and_mask_match_jax(arch):
    jarch, cfg, params, model = _pair(arch)
    ids, mask, comps, _ = _batch(cfg.vocab_size)
    want = jgrpo._completion_logps(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(comps), jarch)
    with torch.no_grad():
        got = tgrpo._completion_logps(model, _t(ids), _t(mask), _t(comps))
    assert got.dtype == torch.float32 and got.shape == comps.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGP_ATOL)
    cm = tgrpo.completion_token_mask(_t(comps))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jgrpo.completion_token_mask(jnp.asarray(comps))))
    assert cm[0].tolist() == [1.0] * 5 + [0.0] * 5  # up to and including the first EOS


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_loss_and_grads_match_jax(arch):
    jarch, cfg, params, model = _pair(arch)
    adapters = _adapters(params)
    ids, mask, comps, adv = _batch(cfg.vocab_size)
    lcfg = jlora.LoraConfig(**LORA)
    jtrainer = jgrpo.GRPOTrainer(params, cfg, support_ticket_reward, jgrpo.GRPOConfig(lora=lcfg), arch=jarch)
    cm = jgrpo.completion_token_mask(jnp.asarray(comps))
    ref = jgrpo._completion_logps(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(comps), jarch)
    (jloss, (jpg, jkl)), jgrads = jtrainer._grad_fn(adapters, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(comps),
                                                    cm, jnp.asarray(adv), ref)
    trainer = tgrpo.GRPOTrainer(model, support_ticket_reward, tgrpo.GRPOConfig(lora=tlora.LoraConfig(**LORA)))
    (loss, (pg, kl)), grads = trainer.loss_and_grads(_tree(adapters), _t(ids), _t(mask), _t(comps), _t(cm), _t(adv),
                                                     _t(ref))
    for got, want in ((loss, jloss), (pg, jpg), (kl, jkl)):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert float(kl) > 0  # b is nonzero: the policy is not the base
    for name in lcfg.targets:
        for part in ("a", "b"):
            g, want = grads[name][part].numpy(), np.asarray(jgrads[name][part])
            assert g.shape == want.shape
            assert np.abs(g - want).max() <= GRAD_REL * np.abs(want).max(), (name, part)


def test_gradient_reaches_only_the_adapters():
    _, cfg, _, model = _pair("qwen3")
    ids, mask, comps, adv = _batch(cfg.vocab_size)
    trainer = tgrpo.GRPOTrainer(model, support_ticket_reward, tgrpo.GRPOConfig(lora=tlora.LoraConfig(**LORA)))
    with torch.no_grad():
        ref = tgrpo._completion_logps(model, _t(ids), _t(mask), _t(comps))
    cm = tgrpo.completion_token_mask(_t(comps))
    (_, (_, kl)), grads = trainer.loss_and_grads(trainer.adapters, _t(ids), _t(mask), _t(comps), cm, _t(adv), ref)
    assert float(kl) == 0.0  # b = 0: the policy is the base
    for name, ab in grads.items():
        assert not ab["a"].any(), name
        assert ab["b"].abs().max() > 0, name
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    assert all(p.grad is None for p in trainer._params)  # grads are returned, not accumulated


def _jax_trainer_pair(arch: str = "qwen3"):
    jarch, cfg, params, model = _pair(arch)
    lcfg = jlora.LoraConfig(**LORA)
    jtrainer = jgrpo.GRPOTrainer(params, cfg, support_ticket_reward, jgrpo.GRPOConfig(lora=lcfg, learning_rate=1e-2),
                                 arch=jarch)
    jtrainer.adapters = _adapters(params)
    trainer = tgrpo.GRPOTrainer(model, support_ticket_reward,
                                tgrpo.GRPOConfig(lora=tlora.LoraConfig(**LORA), learning_rate=1e-2))
    with torch.no_grad():
        for n, p in tgrpo._leaf_order(trainer.adapters):
            trainer.adapters[n][p].copy_(_t(jtrainer.adapters[n][p]))
    return jtrainer, trainer


def _grads_like(adapters, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: {p: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.01 for p, v in ab.items()}
            for n, ab in adapters.items()}


def _assert_adapters_close(trainer, jadapters, rtol=OPT_RTOL, atol=OPT_ATOL):
    for n, p in tgrpo._leaf_order(trainer.adapters):
        np.testing.assert_allclose(trainer.adapters[n][p].detach().numpy(), np.asarray(jadapters[n][p]), rtol=rtol,
                                   atol=atol)


def test_adamw_update_matches_optax():
    jtrainer, trainer = _jax_trainer_pair()
    for seed in (0, 1):
        grads = _grads_like(jtrainer.adapters, seed)
        jtrainer.opt_state, jtrainer.adapters = jtrainer._update(jtrainer.opt_state, jtrainer.adapters, grads)
        trainer._update(_tree(grads))
        _assert_adapters_close(trainer, jtrainer.adapters)
    assert all(p.grad is None for p in trainer._params)


def test_adam_step_matches_optax():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    tparams = {k: _t(v).requires_grad_() for k, v in params.items()}
    topt = torch.optim.Adam(list(tparams.values()), lr=1e-2, **tpretrain.ADAM)
    for _ in range(2):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        topt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=OPT_RTOL, atol=OPT_ATOL)


def test_state_files_cross_packages(tmp_path):
    # JAX -> port
    jtrainer, trainer = _jax_trainer_pair()
    g0, g1 = _grads_like(jtrainer.adapters, 0), _grads_like(jtrainer.adapters, 1)
    jtrainer.opt_state, jtrainer.adapters = jtrainer._update(jtrainer.opt_state, jtrainer.adapters, g0)
    jtrainer.save_state(tmp_path / "jax.npz")
    trainer.load_state(tmp_path / "jax.npz")
    _assert_adapters_close(trainer, jtrainer.adapters, 0, 0)
    jtrainer.opt_state, jtrainer.adapters = jtrainer._update(jtrainer.opt_state, jtrainer.adapters, g1)
    trainer._update(_tree(g1))
    _assert_adapters_close(trainer, jtrainer.adapters)
    # port -> JAX, from the port's own optimizer state
    trainer._update(_tree(g0))
    trainer.save_state(tmp_path / "port.npz")
    data = np.load(tmp_path / "port.npz")
    assert data["opt/0"].dtype == np.int32 and int(data["opt/0"]) == 3
    jtrainer.load_state(tmp_path / "port.npz")
    _assert_adapters_close(trainer, jtrainer.adapters, 0, 0)
    jtrainer.opt_state, jtrainer.adapters = jtrainer._update(jtrainer.opt_state, jtrainer.adapters, g1)
    trainer._update(_tree(g1))
    _assert_adapters_close(trainer, jtrainer.adapters)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)])
def test_matmul_f32_function_grads_match_plain_autograd(dtype, rel):
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(6, 5, 48, generator=gen).to(dtype)
    w0 = (torch.randn(48, 40, generator=gen) * 0.1).to(dtype)
    g = torch.randn(30, 40, generator=gen)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = layers._MatmulF32.apply(x.reshape(-1, 48), w)
    gx, gw = torch.autograd.grad(y, (x, w), g)
    xp, wp = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    yp = xp.reshape(-1, 48).float() @ wp.float()
    gxp, gwp = torch.autograd.grad(yp, (xp, wp), g)
    assert y.dtype == torch.float32 and gx.dtype == gw.dtype == dtype
    for got, want in ((y, yp), (gx, gxp), (gw, gwp)):
        assert (got.float() - want.float()).abs().max() <= rel * want.float().abs().max()
    # a frozen weight gets no grad
    x = x0.clone().requires_grad_()
    (gx_only,) = torch.autograd.grad(layers._MatmulF32.apply(x.reshape(-1, 48), w0), (x,), g)
    torch.testing.assert_close(gx_only, gx, rtol=0, atol=0)


# --- ports of tests/test_rl.py -----------------------------------------------

CFG = dict(vocab_size=300, dim=32, layers=2, heads=4, kv_heads=2, head_dim=8, mlp_dim=64)


def _small(arch: str):
    """test_rl.py's ``gemma`` and ``qwen3`` fixtures' weights, in the port."""
    if arch == "gemma":
        cfg, params = GemmaConfig(**CFG), gemma_init(jax.random.key(0), GemmaConfig(**CFG))
    else:
        cfg = Qwen3Config(**CFG, tie_embeddings=True)
        params = qwen3_init(jax.random.key(0), cfg)
    tarch = tpolicy.get_arch(arch)
    return tarch.from_params(jax.tree.map(np.asarray, params), tarch.config(**cfg.__dict__), device="cpu")


@pytest.mark.parametrize("arch", ["gemma", "qwen3"])
def test_grpo_smoke_training(arch):
    """Two accumulation windows of GRPO: adapters move, stats finite. The
    random-init policy's rewards are flat (-10 for every completion), so the
    signal is the KL term: ``b`` starts nonzero. (At ``b`` = 0 the port's
    policy and reference passes agree bit for bit, so the gradient is exactly
    zero; the JAX trainer's two passes differ by rounding, which Adam scales
    up to a step of about 1e-8.)"""
    cfg = tgrpo.GRPOConfig(group_size=4, epochs=1, grad_accum=2, max_prompt_len=64, max_new_tokens=8,
                           lora=tlora.LoraConfig(rank=2), seed=0)
    trainer = tgrpo.GRPOTrainer(_small(arch), support_ticket_reward, cfg)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for ab in trainer.adapters.values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen) * 0.05)
    before = {n: ab["b"].detach().clone() for n, ab in trainer.adapters.items()}
    stats = trainer.train(generate_support_tickets(4, seed=3))
    assert sorted(stats) == ["adv_std", "kl", "loss", "mean_reward", "parse_rate"]
    assert all(len(v) == 4 for v in stats.values())
    assert np.isfinite(stats["loss"]).all() and np.isfinite(stats["kl"]).all()
    for n, ab in trainer.adapters.items():
        assert (ab["b"] - before[n]).abs().max() > 0, n  # an optimizer step happened
    assert int(trainer.opt.state[trainer._params[0]]["step"]) == 2


def test_grpo_surrogate_loss_descends():
    """Fixed-batch sanity: repeated GRPO steps on one rollout must reduce the
    policy-gradient surrogate (gradients flow through the LoRA adapters) and
    grow the KL from the frozen base as the policy departs. The batch and the
    adapters are the JAX test's (its trainer's rollout and ``lora_init``), so
    this is the JAX test's trajectory; the port's own rollout is another
    sample."""
    jcfg = GemmaConfig(**CFG)
    params = gemma_init(jax.random.key(0), jcfg)
    jtr = jgrpo.GRPOTrainer(params, jcfg, lambda p, c: 0.0,
                            jgrpo.GRPOConfig(group_size=8, max_new_tokens=8, lora=jlora.LoraConfig(rank=4), seed=0))
    p_ids, p_mask, comps = (_t(x) for x in jtr.rollout("write letters")[:3])
    model = _small("gemma")
    tr = tgrpo.GRPOTrainer(model, lambda p, c: 0.0, tgrpo.GRPOConfig(lora=tlora.LoraConfig(rank=4)))
    adv = torch.tensor([1.0, -1.0] * 4)
    cm = tgrpo.completion_token_mask(comps)
    with torch.no_grad():
        ref_lp = tgrpo._completion_logps(model, p_ids, p_mask, comps)

    ad = {n: {p: x.requires_grad_() for p, x in ab.items()} for n, ab in _tree(jtr.adapters).items()}
    leaves = [ad[n][p] for n, p in tgrpo._leaf_order(ad)]
    opt = torch.optim.AdamW(leaves, lr=1e-2, **tgrpo.ADAMW)
    losses, kls = [], []
    for _ in range(6):
        (loss, (pg, kl)), g = tr.loss_and_grads(ad, p_ids, p_mask, comps, cm, adv, ref_lp)
        losses.append(float(pg))
        kls.append(float(kl))
        for (n, p), leaf in zip(tgrpo._leaf_order(ad), leaves):
            leaf.grad = g[n][p]
        opt.step()
    assert losses[-1] < losses[0] - 0.05
    assert kls[-1] > kls[0]
