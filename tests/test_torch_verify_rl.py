"""The port's verification harness and RL CLIs against the JAX package's, on
the CPU.

- ``rl.verify.evaluate_merged`` on 12 support tickets (the debug Qwen3 of
  ``cli/train_rl.py``, JAX-drawn weights and adapters with ``b`` nonzero,
  batch 8, prompts left-padded to 256, 48 new tokens): every batch's greedy
  tokens equal JAX's, and the three rates equal.
- ``rl.verify.evaluate`` and ``evaluate_merged`` on trained weights, the small
  Qwen3 bases and adapters the JAX trainer wrote under ``benchmarks/rl_demo6``
  (fintech) and ``rl_demo4`` (support), as ``cli/verify_rl.py --dataset-size
  16 --baseline`` runs them: the same rates (some strictly between 0 and
  100: rl_demo6's trained clean-JSON rate is 56.25) and every batch's greedy
  tokens equal JAX's. Read only; the CLIs themselves append to
  ``verify_rl.log`` in the working directory.
- The copied host modules (``rewards``, ``datasets``, ``tokenizer``) give the
  JAX package's records, scores and ids for one seed.
- ``cli/verify_rl.py --device cpu --arch qwen3 --model-size debug`` prints the
  JAX CLI's stats line, both given the same adapters ``.npz`` and the same
  ``--base-params``: a debug Qwen3 tree written by the JAX ``save_params``
  (the two CLIs' inits draw from different generators).
- That native Qwen3 checkpoint loads through the port's ``load_params``; a
  Gemma checkpoint under ``--arch qwen3`` is refused; without a card
  ``cli/train_rl.py`` and ``cli/verify_rl.py`` refuse to run unless given
  ``--device cpu``.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.cli import verify_rl as jcli
from multimodal_embedding_tpu.cli.train_rl import default_gemma_config, default_qwen3_config
from multimodal_embedding_tpu.models.checkpoint import load_params as jax_load_params
from multimodal_embedding_tpu.models.checkpoint import save_params as jax_save_params
from multimodal_embedding_tpu.models.gemma import gemma_init
from multimodal_embedding_tpu.models.qwen3 import qwen3_init
from multimodal_embedding_tpu.rl import datasets as jdata
from multimodal_embedding_tpu.rl import lora as jlora
from multimodal_embedding_tpu.rl import rewards as jrewards
from multimodal_embedding_tpu.rl import tokenizer as jtok
from multimodal_embedding_tpu.rl import verify as jverify
from multimodal_embedding_tpu.rl.policy import QWEN3 as JQWEN3
from multimodal_embedding_tpu_torch.cli import train_rl as tcli_train
from multimodal_embedding_tpu_torch.cli import verify_rl as tcli
from multimodal_embedding_tpu_torch.models.checkpoint import load_params
from multimodal_embedding_tpu_torch.models.qwen3 import Qwen3Config
from multimodal_embedding_tpu_torch.rl import datasets as tdata
from multimodal_embedding_tpu_torch.rl import lora as tlora
from multimodal_embedding_tpu_torch.rl import rewards as trewards
from multimodal_embedding_tpu_torch.rl import tokenizer as ttok
from multimodal_embedding_tpu_torch.rl import verify as tverify
from multimodal_embedding_tpu_torch.rl.policy import QWEN3
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LORA = dict(rank=2, alpha=4)
BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"


@pytest.fixture(scope="module")
def qwen3_debug():
    """(JAX config, JAX params, JAX adapters with a nonzero b)."""
    cfg = default_qwen3_config("debug")
    params = qwen3_init(jax.random.key(7), cfg)
    lcfg = jlora.LoraConfig(**LORA)
    adapters = jlora.lora_init(jax.random.key(8), params, lcfg)
    for i, name in enumerate(lcfg.targets):
        adapters[name]["b"] = 0.05 * jax.random.normal(jax.random.key(20 + i), adapters[name]["b"].shape)
    return cfg, params, adapters


def _recording(fn, out: list):
    def wrapped(*a, **kw):
        toks, logps = fn(*a, **kw)
        out.append(np.asarray(toks))
        return toks, logps

    return wrapped


def test_evaluate_merged_matches_jax(qwen3_debug, monkeypatch):
    cfg, params, adapters = qwen3_debug
    dataset = jdata.generate_support_tickets(12, seed=4)
    jtoks, ttoks = [], []
    monkeypatch.setattr(jverify, "generate", _recording(jverify.generate, jtoks))
    monkeypatch.setattr(tverify, "generate", _recording(tverify.generate, ttoks))
    want = jverify.evaluate_merged(params, adapters, jlora.LoraConfig(**LORA), cfg, dataset, "category",
                                   arch=JQWEN3)
    model = QWEN3.from_params(jax.tree.map(np.asarray, params), Qwen3Config(**cfg.__dict__), device="cpu")
    got = tverify.evaluate_merged(model, jax.tree.map(np.asarray, adapters), tlora.LoraConfig(**LORA), dataset,
                                  "category")
    assert len(jtoks) == len(ttoks) == 2
    for j, t in zip(jtoks, ttoks):
        np.testing.assert_array_equal(t, j)
    assert got == want


@pytest.mark.parametrize("demo, task", [("rl_demo6", "fintech"), ("rl_demo4", "support")])
def test_trained_weights_verify_as_in_jax(demo, task, monkeypatch):
    """The CLIs' verification of a trained base and its adapters (written by
    the JAX package's trainer): the dataset of ``--dataset-size 16 --seed
    42``, the untrained base then the merged policy at the CLI's LoRA rank 16,
    alpha 32."""
    base, adapters = BENCHMARKS / demo / "base_params.npz", BENCHMARKS / demo / "lora_adapters.npz"
    gen, field = {"fintech": ("generate_fintech_dataset", "decision"),
                  "support": ("generate_support_tickets", "category")}[task]
    jtoks, ttoks = [], []
    monkeypatch.setattr(jverify, "generate", _recording(jverify.generate, jtoks))
    monkeypatch.setattr(tverify, "generate", _recording(tverify.generate, ttoks))
    jparams, jcfg = jax_load_params(base)
    dataset = getattr(jdata, gen)(16, seed=43)
    want = [jverify.evaluate(jparams, jcfg, dataset, field, arch=JQWEN3),
            jverify.evaluate_merged(jparams, tcli.load_adapters(str(adapters)), jlora.LoraConfig(), jcfg, dataset,
                                    field, arch=JQWEN3)]
    tree, tcfg = load_params(base)
    model = QWEN3.from_params(tree, tcfg, device="cpu")
    dataset = getattr(tdata, gen)(16, seed=43)
    got = [tverify.evaluate(model, dataset, field),
           tverify.evaluate_merged(model, tcli.load_adapters(str(adapters)), tlora.LoraConfig(), dataset, field)]
    assert got == want
    # each batch of 8 prompts, the base's then the merged policy's: the same greedy ids
    assert len(ttoks) == len(jtoks) == 4
    for t, j in zip(ttoks, jtoks):
        np.testing.assert_array_equal(t, j)
    rates = [s[k] for s in got for k in ("no_think_rate", "clean_json_rate", "accuracy")]
    assert any(0.0 < r < 100.0 for r in rates), rates


def test_host_copies_match_jax():
    for n, seed in ((20, 1), (7, 3)):
        assert tdata.generate_support_tickets(n, seed=seed) == jdata.generate_support_tickets(n, seed=seed)
        assert tdata.generate_fintech_dataset(n, seed=seed) == jdata.generate_fintech_dataset(n, seed=seed)
    completions = [
        '{"category": "BILLING"}', '{"category": "OTHER"}', "<think>hmm</think>", '{"category": "SHIPPING"',
        'sure: "category": "TECHNICAL"', '{"decision": "MANUAL_REVIEW"}', '{"decision": "REJECT_RISK"}',
        '{"decision": "STANDARD_LOAN"}', "", '{"decision": "A_PLUS_TIER"} trailing',
    ]
    for rec in jdata.generate_support_tickets(12, seed=5):
        for c in completions:
            assert trewards.support_ticket_reward(rec["prompt"], c) == jrewards.support_ticket_reward(rec["prompt"], c)
    for rec in jdata.generate_fintech_dataset(12, seed=5):
        assert trewards.fintech_target_decision(rec["prompt"]) == jrewards.fintech_target_decision(rec["prompt"])
        for c in completions:
            assert trewards.fintech_reward(rec["prompt"], c) == jrewards.fintech_reward(rec["prompt"], c)
        for c in completions:
            for field in ("category", "decision"):
                assert tverify.extract_json_field(c, field) == jverify.extract_json_field(c, field)
    texts = ["hello wörld", "", "Ticket #1: refund"]
    for t in texts:
        np.testing.assert_array_equal(ttok.encode(t, 5), jtok.encode(t, 5))
        assert ttok.decode_until_eos(list(jtok.encode(t)) + [jtok.EOS_ID, 70]) == jtok.decode_until_eos(
            list(jtok.encode(t)) + [jtok.EOS_ID, 70])
    for a, b in zip(ttok.pad_left([ttok.encode(t) for t in texts], 8), jtok.pad_left([jtok.encode(t) for t in texts], 8)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def checkpoint_and_adapters(qwen3_debug, tmp_path_factory):
    cfg, params, adapters = qwen3_debug
    d = tmp_path_factory.mktemp("verify_rl")
    base = d / "base.npz"
    jax_save_params(base, jax.tree.map(np.asarray, params), cfg)
    ad = d / "lora_adapters.npz"
    np.savez(ad, **{f"{name}.{part}": np.asarray(ab[part]) for name, ab in adapters.items() for part in ("a", "b")})
    return base, ad


def _stats_line(out: str) -> dict:
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_verify_cli_prints_the_jax_clis_stats(checkpoint_and_adapters, tmp_path, monkeypatch, capsys):
    base, ad = checkpoint_and_adapters
    monkeypatch.chdir(tmp_path)  # both CLIs log to verify_rl.log in the working directory
    args = ["--arch", "qwen3", "--model-size", "debug", "--dataset-size", "8", "--base-params", str(base),
            "--adapters", str(ad), "--lora-rank", "2", "--lora-alpha", "4", "--baseline"]
    assert jcli.main(args) == 0
    want = _stats_line(capsys.readouterr().out)
    assert tcli.main([*args, "--device", "cpu"]) == 0
    got = _stats_line(capsys.readouterr().out)
    assert got == want and got["n"] == 8
    assert all(0.0 <= got[k] <= 100.0 for k in ("no_think_rate", "clean_json_rate", "accuracy"))


def test_native_qwen3_checkpoint_loads(checkpoint_and_adapters, qwen3_debug, tmp_path):
    cfg, params, _ = qwen3_debug
    base, _ = checkpoint_and_adapters
    tree, got = load_params(base)
    assert isinstance(got, Qwen3Config) and got.__dict__ == cfg.__dict__
    np.testing.assert_array_equal(tree["layers"]["attn"]["q_norm"], np.asarray(params["layers"]["attn"]["q_norm"]))
    np.testing.assert_array_equal(tree["embed"], np.asarray(params["embed"]))
    model = QWEN3.from_params(tree, got, device="cpu")
    assert model.embed.dtype == torch.float32 and len(model.layers) == cfg.layers
    # a Gemma checkpoint under --arch qwen3 is refused, as by the JAX CLI
    gemma = tmp_path / "gemma.npz"
    gcfg = default_gemma_config("debug")
    jax_save_params(gemma, jax.tree.map(np.asarray, gemma_init(jax.random.key(0), gcfg)), gcfg)
    with pytest.raises(SystemExit, match="expects Qwen3Config"):
        tcli_train.build_model(tcli.parse_args(["--arch", "qwen3", "--base-params", str(gemma), "--device", "cpu"]))


def test_training_is_not_ported_and_the_card_is_required(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli_train.main(["--model-size", "debug"])
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["--model-size", "debug"])
