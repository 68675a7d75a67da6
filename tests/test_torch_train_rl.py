"""The port's format pretrain, ``params_to_jax`` and ``cli/train_rl.py``
against the JAX package's, on the CPU.

- Three ``supervised_pretrain`` steps from one JAX-drawn tree (the debug
  Qwen3 and Gemma of ``cli/train_rl.py``, batch 4, lr 1e-3, the same numpy
  batch draws): every loss to rtol 1e-5 and every weight to atol 2e-5
  against JAX's (an Adam update moves an element by about lr, so a flipped
  update would show as 2e-3).
- The port of ``tests/test_rl.py::test_supervised_pretrain_teaches_format``:
  150 steps halve the CE on that test's Qwen3 config; the port trains the
  module in place and hands it back frozen.
- ``params_to_jax`` gives back the JAX tree a module was loaded from,
  bit-equal, for the decoders and a CLIP tower (``encoder.layers``); the
  JAX ``load_params`` reads the port's ``save_params`` file of it.
- ``cli/train_rl.py --device cpu`` (debug size, ``--format-pretrain 3
  --save-base``) writes ``lora_adapters.npz`` and ``training_stats.npz`` in
  the JAX CLI's layout; ``cli/verify_rl.py --device cpu`` reads them with
  the saved base, and the JAX ``verify_rl`` given the same two files prints
  the same stats line.
"""

import ast

import jax
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.cli import verify_rl as jverify_cli
from multimodal_embedding_tpu.cli.train_rl import default_gemma_config, default_qwen3_config
from multimodal_embedding_tpu.models.checkpoint import load_params as jax_load_params
from multimodal_embedding_tpu.models.qwen3 import Qwen3Config, qwen3_init
from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
from multimodal_embedding_tpu.rl import policy as jpolicy
from multimodal_embedding_tpu.rl import pretrain as jpretrain
from multimodal_embedding_tpu.rl.datasets import generate_support_tickets
from multimodal_embedding_tpu_torch.cli import train_rl as tcli
from multimodal_embedding_tpu_torch.cli import verify_rl as tverify_cli
from multimodal_embedding_tpu_torch.models.checkpoint import save_params
from multimodal_embedding_tpu_torch.models.params import params_from_jax, params_to_jax
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
from multimodal_embedding_tpu_torch.models.zoo import load_debug_model
from multimodal_embedding_tpu_torch.rl import policy as tpolicy
from multimodal_embedding_tpu_torch.rl import pretrain as tpretrain
from multimodal_embedding_tpu_torch.rl import tokenizer as ttok
from tests.test_torch_convert import assert_same_tree
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

PRETRAIN_LOSS_RTOL = 1e-5
PRETRAIN_PARAM_ATOL = 2e-5
CHOICES = ["BILLING", "TECHNICAL", "SHIPPING", "OTHER"]


def _pair(arch: str, seed: int = 0):
    cfg = default_qwen3_config("debug") if arch == "qwen3" else default_gemma_config("debug")
    jarch = jpolicy.get_arch(arch)
    params = jarch.init(jax.random.key(seed), cfg)
    tarch = tpolicy.get_arch(arch)
    model = tarch.from_params(jax.tree.map(np.asarray, params), tarch.config(**cfg.__dict__), device="cpu")
    return jarch, cfg, params, model


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_supervised_pretrain_matches_jax(arch):
    jarch, cfg, params, model = _pair(arch)
    pairs = jpretrain.format_pairs(generate_support_tickets(8, seed=7), "category", CHOICES, seed=0)
    assert tpretrain.format_pairs(generate_support_tickets(8, seed=7), "category", CHOICES, seed=0) == pairs
    kw = dict(batch_size=4, learning_rate=1e-3, max_prompt_len=64, max_completion_len=24, seed=0)
    jtrained, jlosses = jpretrain.supervised_pretrain(params, cfg, pairs, 3, arch=jarch, **kw)
    trained, losses = tpretrain.supervised_pretrain(model, pairs, 3, **kw)
    assert trained is model
    np.testing.assert_allclose(losses, jlosses, rtol=PRETRAIN_LOSS_RTOL, atol=0)
    want = params_from_jax(jax.tree.map(np.asarray, jtrained), device="cpu")
    state = model.state_dict()
    assert sorted(state) == sorted(want)
    for name, t in want.items():
        np.testing.assert_allclose(state[name].numpy(), t.numpy(), rtol=0, atol=PRETRAIN_PARAM_ATOL, err_msg=name)


def test_supervised_pretrain_teaches_format():
    """Teacher-forcing CE drops (rl/pretrain.py — the offline stand-in for
    the reference's pretrained base)."""
    cfg = Qwen3Config(vocab_size=300, dim=32, layers=2, heads=4, kv_heads=2, head_dim=8, mlp_dim=64,
                      tie_embeddings=True)
    tarch = tpolicy.get_arch("qwen3")
    model = tarch.from_params(jax.tree.map(np.asarray, qwen3_init(jax.random.key(0), cfg)),
                              tarch.config(**cfg.__dict__), device="cpu")
    before = model.layers[0].mlp["gate"].detach().clone()
    ds = generate_support_tickets(8, seed=7)
    pairs = tpretrain.format_pairs(ds, "category", CHOICES, seed=0)
    trained, losses = tpretrain.supervised_pretrain(
        model, pairs, steps=150, batch_size=8, learning_rate=1e-3, max_prompt_len=64, max_completion_len=24, seed=0,
    )
    assert np.mean(losses[-10:]) < losses[0] * 0.5
    # trained in place, handed back frozen
    assert not torch.equal(trained.layers[0].mlp["gate"], before)
    assert all(not p.requires_grad and p.grad is None for p in trained.parameters())
    ids = torch.from_numpy(ttok.encode(ds[0]["prompt"], 64))[None]
    with torch.no_grad():
        logits = trained.lm_logits(trained(trained.embed_tokens(ids), torch.ones_like(ids), True))[0, -1]
    assert torch.isfinite(logits).all() and int(logits.argmax()) >= 0  # forward healthy post-training


@pytest.mark.parametrize("arch", ["qwen3", "gemma", "OpenAI-CLIP-L"])
def test_params_to_jax_round_trip(arch, tmp_path):
    if arch == "OpenAI-CLIP-L":
        (jinfo,) = jax_models(arch, 8)
        (tinfo,) = get_models_to_test(arch, 8)
        params, cfg = jax_load_debug_model(jinfo, seed=0).params, None
        model = load_debug_model(tinfo, seed=0, device="cpu").model
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    else:
        _, cfg, params, model = _pair(arch, seed=3)
    tree = params_to_jax(model)
    assert_same_tree(tree, params)
    if cfg is not None:
        save_params(tmp_path / "base.npz", tree, cfg)
        got, got_cfg = jax_load_params(tmp_path / "base.npz")
        assert got_cfg == cfg
        assert_same_tree(got, params)


def _stats_line(out: str) -> dict:
    return ast.literal_eval(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen3", "gemma"])
def test_train_then_verify_cli(arch, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the CLIs log to train_rl.log / verify_rl.log in the working directory
    out, base = tmp_path / "rl_out", tmp_path / "base.npz"
    rc = tcli.main([
        "--device", "cpu", "--arch", arch, "--task", "support", "--model-size", "debug", "--dataset-size", "4",
        "--epochs", "1", "--num-generations", "4", "--grad-accum", "2", "--max-new-tokens", "8",
        "--lora-rank", "2", "--format-pretrain", "3", "--save-base", str(base), "--output-dir", str(out),
    ])
    assert rc == 0
    cfg = default_qwen3_config("debug") if arch == "qwen3" else default_gemma_config("debug")
    with np.load(out / "lora_adapters.npz") as ad:
        assert sorted(ad.files) == sorted(f"{t}.{p}" for t in "qkvo" for p in "ab")
        assert ad["q.a"].shape == (cfg.layers, cfg.dim, 2) and ad["o.b"].shape == (cfg.layers, 2, cfg.dim)
    with np.load(out / "training_stats.npz") as st:
        assert sorted(st.files) == ["adv_std", "kl", "loss", "mean_reward", "parse_rate"]
        assert all(st[k].shape == (4,) and np.isfinite(st[k]).all() for k in st.files)
    _, saved_cfg = jax_load_params(base)
    assert saved_cfg == cfg
    capsys.readouterr()
    args = ["--arch", arch, "--model-size", "debug", "--dataset-size", "4", "--base-params", str(base),
            "--adapters", str(out / "lora_adapters.npz"), "--lora-rank", "2"]
    assert tverify_cli.main([*args, "--device", "cpu"]) == 0
    got = _stats_line(capsys.readouterr().out)
    assert got["n"] == 4 and all(0.0 <= got[k] <= 100.0 for k in ("no_think_rate", "clean_json_rate", "accuracy"))
    assert jverify_cli.main(args) == 0
    assert _stats_line(capsys.readouterr().out) == got
