"""Workload B on a (data, model) mesh: the port's GRPO step and rollout on
tensor-parallel decoders against the JAX package's, on the CPU.

One world of 4 gloo ranks (``torch_parallel_world``'s ``grpo`` suite, spawned
once for the module) runs every case on a 2 x 2 and a 1 x 4 mesh (data x
model). The JAX side runs in this process, unsharded, on the same numpy
inputs and weights (drawn by the JAX package, carried by ``params_from_jax``).
f32 throughout. Decoders: ``dryrun_multichip``'s Gemma (4 heads over 2 KV
heads, Dh 8) and Qwen3 (the same widths, untied), a Gemma with one KV head
(kept on every rank), and a Gemma with 3 heads (the attention whole on every
rank, the MLP split).

- One GRPO step from the same adapters (LoRA rank 16, ``b`` drawn nonzero),
  completions, advantages and ``ref_logps``: ``loss_and_grads`` against the
  JAX trainer's ``_grad_fn`` (loss, pg and kl to rtol 1e-5; every adapter
  gradient to max|d| <= 1e-5 max|g|, as ``test_torch_grpo.py``), then one
  ``_update`` against its optax AdamW update at the trainer's lr, 1e-5
  (rtol 1e-6, atol 1e-6, a tenth of the step); gradients and adapters
  bit-equal on every rank. (At lr 1e-2 an element whose gradient is near
  Adam's eps moves by a share of the step that the gradients' last digits
  decide, so the step is compared at the lr the trainer uses.)
- The rollout on each decoder split over the model axis: greedy ``generate``
  gives JAX's tokens exactly; the prefill's cache holds the rank's KV heads;
  sampled tokens, each rank's generator seeded apart, are the same across
  the model axis. The first decode step's logits agree with the same model
  on one rank to 1e-5: a decode step that did not sum its row-split
  products over the model axis differed there.
- ``dryrun_multichip(4, device="cpu")`` prints its summary line with finite
  losses, and reports its launches under the kernels' own names, the f32
  bodies of attention and MaxSim apart (all 0 on the CPU).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models.gemma import GemmaConfig
from multimodal_embedding_tpu.models.qwen3 import Qwen3Config
from multimodal_embedding_tpu.rl import grpo as jgrpo
from multimodal_embedding_tpu.rl import lora as jlora
from multimodal_embedding_tpu.rl import policy as jpolicy
from multimodal_embedding_tpu.rl import tokenizer as jtok
from multimodal_embedding_tpu.rl.generate import generate as jax_generate
from multimodal_embedding_tpu.rl.rewards import support_ticket_reward
from multimodal_embedding_tpu_torch.dryrun import DECODER, dryrun_multichip
from multimodal_embedding_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model
from tests.torch_parallel_world import join_world, start_world
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
GRAD_REL = 1e-5  # max|d| / max|g| per adapter tensor
OPT_RTOL, OPT_ATOL = 1e-6, 1e-6
DECODE_ATOL = 1e-5
LR = 1e-5  # the trainer's default (the reference's): an Adam step of 1e-5 an element
MAX_NEW = 6
MESHES = ("2x2", "1x4")
CASES = {
    "gemma": ("gemma", DECODER),
    "qwen3": ("qwen3", {**DECODER, "tie_embeddings": False}),
    "gemma_mqa": ("gemma", {**DECODER, "kv_heads": 1}),
    "gemma_whole": ("gemma", {**DECODER, "heads": 3, "kv_heads": 1}),
}
ROLLOUT = ("qwen3", "gemma", "gemma_mqa")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _config(arch, cfg):
    return (Qwen3Config if arch == "qwen3" else GemmaConfig)(**cfg)


def _batch(rng, vocab: int):
    """4 left-padded prompts of up to 7 tokens, 5-token completions (row 1
    stops at an EOS), advantages."""
    lengths = np.array([7, 5, 6, 3])
    mask = (np.arange(7)[None, :] >= 7 - lengths[:, None]).astype(np.int32)
    ids = (rng.integers(3, vocab - 6, (4, 7)) * mask).astype(np.int32)
    comps = rng.integers(3, vocab - 6, (4, 5)).astype(np.int32)
    comps[1, 2] = jtok.EOS_ID
    adv = rng.normal(size=4).astype(np.float32)
    return ids, mask, comps, adv


_jax_logps = jax.jit(jgrpo._completion_logps, static_argnums=(1, 5))


def _case(i: int, arch: str, cfg: dict, rng):
    """JAX params, adapters (numpy: ``a`` normal / r, ``b`` normal * 0.05,
    so the policy is not the base), and the batch with the base's
    ``ref_logps`` from JAX."""
    jarch, jcfg = jpolicy.get_arch(arch), _config(arch, cfg)
    params = _np(jarch.init(jax.random.key(10 + i), jcfg))
    lcfg = jlora.LoraConfig()
    adapters = {}
    for name in lcfg.targets:
        n_layers, d_in, d_out = params["layers"]["attn"][name].shape
        adapters[name] = {"a": (rng.standard_normal((n_layers, d_in, lcfg.rank)) / lcfg.rank).astype(np.float32),
                          "b": (rng.standard_normal((n_layers, lcfg.rank, d_out)) * 0.05).astype(np.float32)}
    ids, mask, comps, adv = _batch(rng, cfg["vocab_size"])
    cm = np.asarray(jgrpo.completion_token_mask(jnp.asarray(comps)))
    ref = np.asarray(_jax_logps(params, jcfg, ids, mask, comps, jarch))
    return {"arch": arch, "cfg": cfg, "tree": params, "adapters": adapters, "batch": (ids, mask, comps, cm, adv, ref)}


def _jax_step(case: dict) -> dict:
    """The JAX trainer's gradient and AdamW update on a case."""
    jarch, jcfg = jpolicy.get_arch(case["arch"]), _config(case["arch"], case["cfg"])
    trainer = jgrpo.GRPOTrainer(jax.tree.map(jnp.asarray, case["tree"]), jcfg, support_ticket_reward,
                                jgrpo.GRPOConfig(lora=jlora.LoraConfig(), learning_rate=LR), arch=jarch)
    (loss, (pg, kl)), grads = trainer._grad_fn(case["adapters"], *(jnp.asarray(x) for x in case["batch"]))
    _, after = trainer._update(trainer.opt.init(case["adapters"]), case["adapters"], grads)
    return {"terms": [float(loss), float(pg), float(kl)], "grads": _np(grads), "after": _np(after)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX results by case, JAX greedy tokens by decoder, the prompts, each
    rank's results) of one 4-rank world, which runs while JAX computes."""
    rng = np.random.default_rng(0)
    ids, mask, _, _ = _batch(rng, DECODER["vocab_size"])
    cases = {name: _case(i, arch, cfg, rng) for i, (name, (arch, cfg)) in enumerate(CASES.items())}
    inp = {"cases": cases, "lr": LR, "prompts": (ids, mask), "rollout": ROLLOUT, "max_new": MAX_NEW}
    work = tmp_path_factory.mktemp("grpo_world")
    procs = start_world("grpo", 4, work, inp)
    want = {name: _jax_step(case) for name, case in cases.items()}
    greedy = {}
    for name in ROLLOUT:
        arch, cfg = CASES[name]
        toks, _ = jax_generate(cases[name]["tree"], _config(arch, cfg), jnp.asarray(ids), jnp.asarray(mask),
                               jax.random.key(0), max_new=MAX_NEW, greedy=True, arch=jpolicy.get_arch(arch))
        greedy[name] = np.asarray(toks)
    return want, greedy, mask, join_world(procs, work)


def _bit_equal_on_every_rank(outs, key, part):
    first = outs[0][key][part]
    for o in outs[1:]:
        for n, ab in first.items():
            for p, x in ab.items():
                np.testing.assert_array_equal(o[key][part][n][p], x, err_msg=f"{key} {part} {n}.{p}")
    return first


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_grpo_step_on_a_mesh_matches_jax(world, mesh, case):
    want, _, _, outs = world
    key = (mesh, case)
    for o in outs:
        for got, w in zip(o[key]["terms"], want[case]["terms"]):
            np.testing.assert_allclose(got, w, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert want[case]["terms"][2] > 0  # b is nonzero: the policy is not the base
    grads = _bit_equal_on_every_rank(outs, key, "grads")
    for n, ab in want[case]["grads"].items():
        for p, w in ab.items():
            assert grads[n][p].shape == w.shape
            assert np.abs(grads[n][p] - w).max() <= GRAD_REL * np.abs(w).max(), (n, p)
    after = _bit_equal_on_every_rank(outs, key, "after")
    for n, ab in want[case]["after"].items():
        for p, w in ab.items():
            np.testing.assert_allclose(after[n][p], w, rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=f"{n}.{p}")


@pytest.mark.parametrize("mesh,heads", [("2x2", 2), ("1x4", 1)])
def test_decoder_attention_split_is_recorded(world, mesh, heads):
    _, _, _, outs = world
    dh = DECODER["head_dim"]
    for r, o in enumerate(outs):
        model_rank = r % (2 if mesh == "2x2" else 4)
        split = o[mesh, "gemma"]["split"]
        assert o[mesh, "gemma"]["q_shape"] == (DECODER["dim"], heads * dh)
        assert (split.q.start, split.q.stop) == (model_rank * heads * dh, (model_rank + 1) * heads * dh)
        kv_head = model_rank * heads // 2  # 2 query heads a KV head
        assert (split.kv.start, split.kv.stop) == (kv_head * dh, (kv_head + 1) * dh)
        mqa = o[mesh, "gemma_mqa"]["split"]
        assert (mqa.kv.start, mqa.kv.stop) == (0, dh)  # the one KV head on every rank
        # 3 heads divide neither axis: the attention whole, no record
        assert o[mesh, "gemma_whole"]["split"] is None
        assert o[mesh, "gemma_whole"]["q_shape"] == (DECODER["dim"], 3 * dh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ROLLOUT)
def test_rollout_on_a_split_decoder(world, mesh, case):
    _, greedy, _, outs = world
    n_model = 2 if mesh == "2x2" else 4
    kv_heads = CASES[case][1]["kv_heads"]
    for r, o in enumerate(outs):
        got = o[mesh, case, "rollout"]
        np.testing.assert_array_equal(got["greedy"], greedy[case])
        assert got["cache_heads"] == max(kv_heads // n_model, 1)
        assert got["decode_diff"] <= DECODE_ATOL, got["decode_diff"]
        # the model group's first rank samples; its tokens on every rank of the group
        first = outs[r - r % n_model][mesh, case, "rollout"]["sampled"]
        np.testing.assert_array_equal(got["sampled"], first)
    assert got["sampled"].shape == greedy[case].shape


def test_split_weights_hold_only_their_slice():
    """A split weight is a copy of its slice: a row slice kept as a view held
    the whole weight's storage (at Qwen3-14B, 4.6 GB a rank of o and down)."""
    from multimodal_embedding_tpu_torch.models.gemma import Gemma
    from multimodal_embedding_tpu_torch.models.gemma import GemmaConfig as TGemmaConfig
    from multimodal_embedding_tpu_torch.parallel.mesh import Mesh
    from multimodal_embedding_tpu_torch.parallel.tp import shard_params_tp

    model = shard_params_tp(Gemma(TGemmaConfig(**DECODER), gen=torch.Generator().manual_seed(0), device="cpu",
                                  dtype=torch.float32), Mesh(n_data=1, n_model=2, model_rank=1))
    layer = model.layers[0]
    assert layer.attn["o"].shape == (16, 32) and layer.mlp["down"].shape == (32, 32)
    for name, p in model.named_parameters():
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name


def test_collectives_are_the_identity_without_a_group():
    x = torch.randn(3, 4, requires_grad=True)
    assert copy_to_model(x, None) is x and reduce_from_model(x, None) is x


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    out = dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == out["line"]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 4, 'model': 1}, scores (8, 8)/(8, 40), maxsim (8, 8)")
    assert "tp mesh={'data': 2, 'model': 2} encode ok, sp attention ok" in line
    losses = [float(x) for x in re.findall(r"loss=(\S+) ok", line)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses + [out["loss"], out["qwen3_loss"]])
    # each kernel's launches under its own name, the f32 bodies apart; none on the CPU
    assert out["launches"] == dict.fromkeys(("fused_attention", "fused_attention_f32", "preprocess", "maxsim",
                                             "maxsim_f32"), 0)
