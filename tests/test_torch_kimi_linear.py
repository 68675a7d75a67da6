"""Kimi-Linear's hybrid decoder (``models/kimi_linear.py``) that ColPali runs
for Kimi-Linear-48B-A3B's language model, its KDA recurrence
(``ops/kda.py``), its converter, its registry entry and its benchmark cell, on
the CPU at a small size: width 64, 5 layers (KDA, KDA, KDA, MLA, KDA; KDA 4
heads of 16), 8 experts at top-2 and a shared one, f32, weights drawn from a
seed.

- The port's ColPali in f32 against the plain reference
  (``perfbench/reference/colpali_kda.py``) on the same HF-layout weights,
  pages and padded captions: 1e-5 relative, as ``test_torch_granite.py``
  holds the Granite variant (f32 products summed in other orders: the port's
  chunked KDA against the reference's token loop, grouped expert rows against
  one masked product an expert); the expert choices equal.
- ``kda_plain`` against a float64 token loop at T = 1, 63, 64, 65 and 130
  (one chunk, its edges, two and three chunks): 1e-5 of the output's largest
  magnitude (f32 sums over a chunk's cumulative log decays).
- ``kda_plain`` with each head's channels given one decay against
  ``transformers``' ``torch_recurrent_gated_delta_rule`` (Qwen3-Next's scalar
  gated delta rule, token by token): 1e-5 of the largest output.
- Strong decays (A up to 16, dt up to 1: a chunk's cumulative log decay
  below -100) give finite outputs that match the loop.
- The decoder's final hidden states against the reference's, 1e-6 relative:
  a recurrence whose state is zeroed at each chunk, one whose decays are the
  mean over each head's channels, one with beta fixed at 1 and one with its
  decays rounded to bf16 each fail it; ``perfbench/faults_kda.py``'s
  stand-ins compute the faults they name.
- The DeepSeek decoder's rope path (Kimi-VL) bit for bit its code before the
  NoPE switch; the NoPE path leaves the rope parts unrotated.
- The benchmark cell's toy (``kimi_linear_tiny.py``) through the harness: a
  sound run is ``correct`` with room, the fp8 control and a recurrence
  without its carried state are not; a traced run reads the new per-layer
  metrics.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models import deepseek
from multimodal_embedding_tpu_torch.models.arch import colpali_word_tokenizer, full_colpali_kimi_linear_config
from multimodal_embedding_tpu_torch.models.colpali import (
    LM_PREFIX,
    ColPaliConfig,
    colpali_kimi_linear_from_hf,
    debug_colpali_config,
)
from multimodal_embedding_tpu_torch.models.deepseek import DeepseekLM
from multimodal_embedding_tpu_torch.models.kimi_linear import KimiLinearLM, kimi_linear_config_from_hf
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test, model_info
from multimodal_embedding_tpu_torch.ops import kda as tkda
from multimodal_embedding_tpu_torch.ops import kda_cuda
from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn
from perfbench import weights_kda, yardstick_kda
from perfbench.harness import ROOT, Bench, Run, check, measure, verdict
from perfbench.reference import colpali_kda as ref
from tests.kimi_linear_tiny import CELL, LIMITS, config, make_kda_root
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
RTOL_LM = 1e-6
SEED = 2**31 + 7
TEXTS = ["a red dog on the left", "two cats", "the bus is near the window in the picture and a man crosses"]
FULL = json.loads((ROOT / "perfbench" / "configs" / "colpali-kimi-linear-48b-a3b.json").read_text())
CATALOG = {  # the catalog row's config (moonshotai/Kimi-Linear-48B-A3B-Instruct config.json)
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
    "intermediate_size": 9216, "kv_lora_rank": 512, "mla_use_nope": True, "model_max_length": 1048576,
    "model_type": "kimi_linear", "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32, "num_expert_group": 1, "num_experts": 256,
    "num_experts_per_token": 8, "num_hidden_layers": 27, "num_key_value_heads": 32, "num_nextn_predict_layers": 0,
    "num_shared_experts": 1, "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000, "routed_scaling_factor": 2.446,
    "tie_word_embeddings": False, "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840}


def colpali_cfg(cfg: dict) -> ColPaliConfig:
    base = debug_colpali_config()
    return ColPaliConfig(vision=base.vision, gemma=kimi_linear_config_from_hf(cfg), embedding_dim=cfg["embedding_dim"])


def draw(cfg: dict, seed: int = SEED):
    return lambda part: weights_kda.draw(cfg, part, seed, device="cpu", dtype=torch.float32)


def load(cfg: dict, seed: int = SEED):
    d = draw(cfg, seed)
    return colpali_kimi_linear_from_hf((d(p) for p in weights_kda.parts(cfg)), colpali_cfg(cfg),
                                       cfg["image_suffix_ids"], dtype=torch.float32)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


# --- configuration -------------------------------------------------------------


def test_debug_config_is_the_tests_size():
    lm = debug_colpali_config(decoder="kimi_linear").gemma
    assert (lm.dim, lm.layers, lm.kda_layers, lm.kda_heads, lm.kda_head_dim, lm.n_experts, lm.top_k, lm.n_shared) == (
        64, 5, (0, 1, 2, 4), 4, 16, 8, 2, 1)
    assert lm == kimi_linear_config_from_hf(config())


def test_arch_config_is_the_catalog_row_cut_to_16_layers():
    """The registry's full-width model and the benchmark's configuration file
    name the same language model: every catalog key as published but the
    depth and the layer lists, which are cut to layers 1-16."""
    lm = full_colpali_kimi_linear_config().gemma
    assert kimi_linear_config_from_hf(FULL) == lm
    assert (lm.layers, len(lm.kda_layers), lm.n_experts, lm.top_k, lm.n_shared, lm.vocab_size) == (
        16, 12, 256, 8, 1, 163840)
    assert [i for i in range(16) if i not in lm.kda_layers] == [3, 7, 11, 15]
    assert (lm.dim, lm.kda_heads, lm.kda_head_dim, lm.conv_width, lm.mlp_dim, lm.moe_dim) == (
        2304, 32, 128, 4, 9216, 1024)
    assert (lm.heads, lm.kv_rank, lm.qk_nope_dim, lm.qk_rope_dim, lm.v_dim, lm.nope) == (32, 512, 128, 64, 128, True)
    pub_kda = FULL["published"]["linear_attn_config"]["kda_layers"]
    assert lm.kda_layers == tuple(i - 1 for i in pub_kda if i <= 16)
    for key, value in CATALOG.items():
        assert FULL[key] == value or key in FULL["reduced"], key
    assert FULL["reduced"] == ["num_hidden_layers", "linear_attn_config"] and FULL["num_hidden_layers"] == 16
    lin, pub = FULL["linear_attn_config"], FULL["published"]["linear_attn_config"]
    assert lin["kda_layers"] == [i for i in pub["kda_layers"] if i <= 16]
    assert lin["full_attn_layers"] == [i for i in pub["full_attn_layers"] if i <= 16]
    assert {k: v for k, v in lin.items() if "layers" not in k} == {k: v for k, v in pub.items() if "layers" not in k}


@pytest.mark.parametrize("key, value", [("q_lora_rank", 1536), ("moe_router_activation_func", "softmax"),
                                        ("num_expert_group", 8), ("hidden_act", "gelu"),
                                        ("linear_attn_config", {"kda_layers": [1, 2], "full_attn_layers": [4],
                                                                "num_heads": 4, "head_dim": 16,
                                                                "short_conv_kernel_size": 4})])
def test_config_refuses_what_it_does_not_run(key, value):
    cfg = config()
    cfg[key] = value
    with pytest.raises(ValueError):
        kimi_linear_config_from_hf(cfg)


def test_weights_draw_the_kda_initialiser():
    """A in [1, 16] a head, dt = softplus(dt_bias) in [0.001, 0.1] a channel,
    both f32; the convs in +-1/2 with no bias; the same part from the same
    seed twice is the same."""
    cfg = config()
    part = draw(cfg)("layer.0")
    a_ = f"{LM_PREFIX}.layers.0.self_attn"
    a = torch.exp(part[f"{a_}.A_log"])
    dt = F.softplus(part[f"{a_}.dt_bias"])
    assert part[f"{a_}.A_log"].shape == (4,) and part[f"{a_}.dt_bias"].shape == (64,)
    assert bool(((a >= 1) & (a <= 16)).all()) and bool(((dt >= 0.001 - 1e-7) & (dt <= 0.1 + 1e-6)).all())
    assert float(part[f"{a_}.q_conv1d.weight"].abs().max()) <= 0.5 and f"{a_}.q_conv1d.bias" not in part
    assert all(torch.equal(v, draw(cfg)("layer.0")[k]) for k, v in part.items())
    assert f"{LM_PREFIX}.layers.3.self_attn.kv_b_proj.weight" in draw(cfg)("layer.3")
    assert f"{LM_PREFIX}.layers.2.block_sparse_moe.experts.7.w3.weight" in draw(cfg)("layer.2")
    bf16 = weights_kda.draw(cfg, "layer.1", SEED, device="cpu", dtype=torch.bfloat16)
    assert bf16[f"{LM_PREFIX}.layers.1.self_attn.A_log"].dtype == torch.float32
    assert bf16[f"{LM_PREFIX}.layers.1.self_attn.q_conv1d.weight"].dtype == torch.bfloat16


# --- the port against the reference ---------------------------------------------


@pytest.mark.parametrize("seed", [SEED, 5])
def test_port_matches_the_plain_reference_in_f32(seed):
    cfg = config()
    model = load(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    imgs = [torch.randint(0, 256, (3, 40, 50), dtype=torch.uint8, generator=gen) for _ in range(3)]
    want = ref.embed(imgs, TEXTS, draw(cfg, seed), cfg, "f32", "cpu")
    pre = make_preprocess_fn(model_info("ColPali-Kimi-Linear-48B-A3B").preprocess.__class__(
        image_size=28, resize_mode="exact", interpolation="bicubic", mean=(0.5,) * 3, std=(0.5,) * 3),
        40, 50, device="cpu", input_format="nchw")
    model.gemma.route_sink = []
    pages = model.image_fwd(torch.cat([pre(im[None]) for im in imgs]))
    ids, mask = colpali_word_tokenizer(cfg["vocab_size"])(TEXTS)
    assert np.array_equal(ids, ref.tokenize_queries(TEXTS, cfg["vocab_size"])[0].numpy())
    queries = model.text_fwd(torch.as_tensor(ids).long(), torch.as_tensor(mask))
    assert rel(pages, want["pages"]) < RTOL and rel(queries, want["queries"]) < RTOL
    n = int(mask[1].sum())
    assert float(queries.abs().sum()) > 0 and not queries[1, n:].any()
    page_routes, query_routes = (torch.stack(call, dim=1).sort(dim=-1).values for call in model.gemma.route_sink)
    assert torch.equal(page_routes.view(want["page_routes"].shape), want["page_routes"])
    assert torch.equal(query_routes.view(want["query_routes"].shape), want["query_routes"])
    assert not want["page_margin"].any()


def test_converter_refuses_a_model_left_half_filled():
    cfg = config()
    d = draw(cfg)
    with pytest.raises(ValueError, match="not filled"):
        colpali_kimi_linear_from_hf([d("vision"), d("misc"), d("layer.0")], colpali_cfg(cfg), cfg["image_suffix_ids"],
                                    dtype=torch.float32)


def _lm_gap(monkeypatch, fault=None, masked=True) -> float:
    """The port's final hidden states against the reference's on the same
    caption embeddings, relative, with ``fault`` in place of ``kda_plain``."""
    if fault is not None:
        monkeypatch.setattr(tkda, "kda_plain", fault)
    cfg = config()
    model = load(cfg)
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(cfg["vocab_size"])(TEXTS))
    if not masked:
        mask = torch.ones_like(mask)
    d = draw(cfg)
    c = ref.moe_config(cfg)
    with torch.no_grad():
        got = model.gemma(model.gemma.embed_tokens(ids), attn_mask=mask)
        h = model.gemma.embed_tokens(ids)
        for i in range(cfg["num_hidden_layers"]):
            h = ref.decoder_layer(h, d(f"layer.{i}"), i, c, "f32", mask)[0]
        want = ref.rms_norm(h, d("misc")[f"{LM_PREFIX}.norm.weight"], cfg["rms_norm_eps"])
    valid = mask.bool()
    return rel(got[valid], want[valid])


@pytest.mark.parametrize("masked", [True, False], ids=["padded", "whole"])
def test_decoder_matches_the_reference_on_the_same_inputs(monkeypatch, masked):
    assert _lm_gap(monkeypatch, masked=masked) < RTOL_LM


def test_right_padded_rows_keep_their_valid_outputs():
    """A caption's valid outputs alone and in a batch padded past it agree
    (the causal convs, recurrence and attention never read a later pad)."""
    model = load(config())
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(512)(TEXTS))
    with torch.no_grad():
        batch = model.text_fwd(ids, mask)
        for row in range(len(TEXTS)):
            n = int(mask[row].sum())
            alone = model.text_fwd(ids[row:row + 1, :n], mask[row:row + 1, :n])
            assert rel(batch[row, :n], alone[0]) < RTOL_LM
            assert not batch[row, n:].any()


def test_left_padded_rows_keep_their_valid_outputs():
    """A left-padded row's valid hidden states equal the row's alone: its
    pads reach the convs and the state as zeros and leave the state at 0."""
    model = load(config())
    lm = model.gemma
    ids = torch.tensor([[0, 0, 0, 5, 9, 100, 7, 3], [8, 1, 2, 4, 6, 11, 12, 13]])
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1], [1] * 8])
    with torch.no_grad():
        both = lm(lm.embed_tokens(ids), attn_mask=mask)
        alone = lm(lm.embed_tokens(ids[:1, 3:]), attn_mask=mask[:1, 3:])
    assert rel(both[0, 3:], alone[0]) < RTOL_LM


# --- the recurrence -----------------------------------------------------------------


def _loop64(q, k, v, g, beta):
    """The recurrence token by token in float64, q and k normalised."""
    q, k, v, g, beta = (x.double() for x in (q, k, v, g, beta))
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-6) * q.shape[-1] ** -0.5
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-6)
    b, t, h, kd = q.shape
    state = torch.zeros(b, h, kd, v.shape[-1], dtype=torch.float64)
    out = []
    for i in range(t):
        state = state * torch.exp(g[:, i])[..., None]
        u = beta[:, i, :, None] * (v[:, i] - torch.einsum("bhk,bhkv->bhv", k[:, i], state))
        state = state + k[:, i, :, :, None] * u[:, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", q[:, i], state))
    return torch.stack(out, dim=1)


def _kda_inputs(t: int, seed: int = 0, b: int = 2, h: int = 3, kd: int = 16, a_max: float = 16.0,
                dt_max: float = 0.1):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, kd, generator=gen) for _ in range(3))
    a = 1 + (a_max - 1) * torch.rand(h, generator=gen)
    dt = torch.exp(math.log(1e-3) + torch.rand(b, t, h, kd, generator=gen) * (math.log(dt_max) - math.log(1e-3)))
    g = -a[:, None] * dt
    beta = torch.sigmoid(torch.randn(b, t, h, generator=gen))
    return q, k, v, g, beta


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130])
def test_plain_kda_matches_a_float64_loop(t):
    args = _kda_inputs(t, seed=t)
    want = _loop64(*args)
    got = tkda.kda(*args)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_plain_kda_with_one_decay_a_head_is_the_gated_delta_rule():
    """Each head's channels given one decay: the scalar gated delta rule,
    as ``transformers`` writes it token by token for Qwen3-Next."""
    from transformers.models.qwen3_next.modeling_qwen3_next import torch_recurrent_gated_delta_rule

    q, k, v, g, beta = _kda_inputs(97, seed=4)
    g1 = g.mean(-1)
    want, _ = torch_recurrent_gated_delta_rule(q, k, v, g1, beta, None, False, use_qk_l2norm_in_kernel=True)
    got = tkda.kda_plain(q, k, v, g1[..., None].expand_as(g).contiguous(), beta)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((tkda.kda_plain(q, k, v, g, beta) - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_strong_decays_stay_finite():
    """A up to 16 and dt up to 1: a 64-token chunk's cumulative log decay
    falls below -100 in some channels, where exp(-cum) overflows f32 (past
    exp(88.7)); the plain form, which forms each pair's decay whole, stays
    finite and matches the loop."""
    args = _kda_inputs(130, seed=9, a_max=16.0, dt_max=1.0)
    cum = torch.cumsum(args[3][:, :64], dim=1)
    assert float(cum.min()) < -100
    got = tkda.kda_plain(*args)
    assert bool(torch.isfinite(got).all())
    want = _loop64(*args)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_plain_kda_carries_the_state_across_chunks():
    """The whole sequence at chunk 16 equals chunk 128 (one chunk), and both
    differ from the chunks run apart."""
    args = _kda_inputs(96, seed=3, dt_max=0.01)
    whole, small = tkda.kda_plain(*args, chunk=128), tkda.kda_plain(*args, chunk=16)
    assert float((whole - small).abs().max()) <= 1e-5 * float(whole.abs().max())
    apart = torch.cat([tkda.kda_plain(*(x[:, s:s + 16] for x in args)) for s in range(0, 96, 16)], dim=1)
    assert float((apart - whole).abs().max()) > 1e-2 * float(whole.abs().max())


def test_kda_wrapper_refuses_before_launch():
    """The kernel's wrapper takes only card tensors of the head size and
    strides it reads; the dispatcher sends CPU tensors to the plain version."""
    q, k, v, g, beta = _kda_inputs(6, kd=128)
    with pytest.raises(ValueError, match="cuda"):
        kda_cuda.kda(q, k, v, g, beta)
    assert tkda.kda(q, k, v, g, beta).device.type == "cpu"


# --- planted faults -----------------------------------------------------------------

_PLAIN = tkda.kda_plain  # the sound recurrence, which each fault below wraps


def _no_carry(q, k, v, g, beta, *, chunk=64):
    """The recurrence with its state zeroed at the start of each chunk."""
    return torch.cat([_PLAIN(*(x[:, s:s + chunk] for x in (q, k, v, g, beta)), chunk=chunk)
                      for s in range(0, q.shape[1], chunk)], dim=1)


def _scalar_decay(q, k, v, g, beta, *, chunk=64):
    """Each head's decay the mean over its channels (the scalar gated delta rule)."""
    return _PLAIN(q, k, v, g.mean(-1, keepdim=True).expand_as(g), beta, chunk=chunk)


def _beta_one(q, k, v, g, beta, *, chunk=64):
    return _PLAIN(q, k, v, g, torch.ones_like(beta), chunk=chunk)


def _bf16_decays(q, k, v, g, beta, *, chunk=64):
    """Each decay exp(g) rounded to bf16."""
    return _PLAIN(q, k, v, torch.log(torch.exp(g).bfloat16().float()), beta, chunk=chunk)


FAULTS = {"no_carry": _no_carry, "scalar_decay": _scalar_decay, "beta_one": _beta_one, "bf16_decays": _bf16_decays}


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_kda_fault_fails_the_compare(monkeypatch, name):
    """Each fault moves the decoder's hidden states past 1e-6 of the
    reference's; the toy captions are shorter than a chunk, so the state
    fault is planted at chunk 8."""
    fault = FAULTS[name]
    if name == "no_carry":
        def fault(*args, chunk=64):  # noqa: F811
            return _no_carry(*args, chunk=8)
    assert _lm_gap(monkeypatch, fault) > RTOL_LM


@pytest.mark.parametrize("name", ["kda_no_carry", "kda_scalar_decay", "kda_beta_one", "kda_bf16_decays"])
def test_benchmark_faults_are_the_faults_they_name(name):
    """``perfbench/faults_kda.py``'s stand-ins on the CPU at 150 tokens: each
    within 1e-5 of its largest output (f32 sums in other orders) of the fault
    above that it names, and away from the sound recurrence."""
    from perfbench import faults_kda

    args = _kda_inputs(150, seed=6)
    want = FAULTS[name[4:]](*args)
    got = faults_kda.FAULTS[name](*args)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((got - _PLAIN(*args)).abs().max()) > 1e-4 * float(want.abs().max())


# --- the DeepSeek decoder's NoPE switch ------------------------------------------------


def _qkv_before(layer, x, positions):
    """``DeepseekLayer.qkv`` as written before the NoPE switch."""
    cfg, p = layer.cfg, layer.attn
    b, t, _ = x.shape
    q = (x @ p["q"]).view(b, t, cfg.heads, cfg.head_dim)
    latent, k_rope = (x @ p["kv_a"]).split([cfg.kv_rank, cfg.qk_rope_dim], dim=-1)
    kv = (deepseek.rms_norm(p["kv_norm"], latent, deepseek.KV_NORM_EPS) @ p["kv_b"]).view(b, t, cfg.heads, -1)
    rot = deepseek.rope_rotation(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = deepseek.rope_interleaved(q[..., cfg.qk_nope_dim:], rot)
    k_rope = deepseek.rope_interleaved(k_rope[:, :, None, :], rot)
    q = torch.cat([q[..., : cfg.qk_nope_dim], q_rope], dim=-1)
    k = torch.cat([kv[..., : cfg.qk_nope_dim], k_rope.expand(b, t, cfg.heads, cfg.qk_rope_dim)], dim=-1)
    return q, k, kv[..., cfg.qk_nope_dim:]


def _forward_before(layer, h, positions, key_mask, causal):
    """``DeepseekLayer.forward`` as written before the mixer hooks."""
    cfg = layer.cfg
    b, t, _ = h.shape
    q, k, v = _qkv_before(layer, layer.norm(layer.ln1, h, cfg.rms_eps), positions)
    v = F.pad(v, (0, cfg.head_dim - cfg.v_dim))
    out = deepseek.grouped_attention(q, k, v, key_mask=key_mask, causal=causal, sm_scale=cfg.head_dim**-0.5)
    out = out.view(b, t, cfg.heads, cfg.head_dim)[..., : cfg.v_dim].reshape(b, t, cfg.heads * cfg.v_dim)
    h = h + out @ layer.attn["o"]
    return h + layer.mlp_out(layer.norm(layer.ln2, h, cfg.rms_eps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kimi_vl_rope_path_is_unchanged(dtype):
    """Kimi-VL's decoder (no ``mla_use_nope``: rope on) gives bit for bit
    what its code gave before the NoPE switch and the mixer hooks."""
    cfg = debug_colpali_config(decoder="deepseek").gemma
    assert cfg.nope is False and deepseek.deepseek_config_from_hf({**_hf_keys(cfg)}).nope is False
    lm = DeepseekLM(cfg, gen=torch.Generator().manual_seed(3), device="cpu", dtype=dtype)
    gen = torch.Generator().manual_seed(4)
    h = (torch.randn(2, 11, cfg.dim, generator=gen) * 0.5).to(dtype)
    mask = torch.tensor([[1] * 11, [1] * 7 + [0] * 4])
    positions = torch.cumsum(mask, dim=-1) - 1
    for layer in lm.layers:
        layer.rope = None
        q0, k0, v0 = _qkv_before(layer, h, positions)
        q1, k1, v1 = layer.qkv(h, positions)
        assert torch.equal(q0, q1) and torch.equal(k0, k1) and torch.equal(v0, v1)
        want = _forward_before(layer, h, positions, mask > 0, True)
        got = layer(h, positions, mask > 0, True)[0]
        assert torch.equal(want, got)


def _hf_keys(cfg) -> dict:
    """``cfg`` under the HF DeepSeek-V3 keys ``deepseek_config_from_hf`` reads."""
    return {hf: getattr(cfg, k) for k, hf in deepseek._HF_KEYS.items()}


def test_nope_leaves_the_rope_parts_unrotated():
    """An MLA layer of the Kimi-Linear decoder puts the shared key's raw
    rope part, the same at every head, and q's raw rope part into q and k."""
    lm = load(config()).gemma
    layer = lm.layers[3]
    assert layer.kind == "mla" and lm.layers[0].kind == "kda"
    cfg = layer.cfg
    x = torch.randn(2, 9, cfg.dim, generator=torch.Generator().manual_seed(1))
    positions = torch.arange(9).expand(2, 9)
    q, k, _ = layer.qkv(x, positions)
    raw_k = (x @ layer.attn["kv_a"])[..., cfg.kv_rank:]
    raw_q = (x @ layer.attn["q"]).view(2, 9, cfg.heads, cfg.head_dim)[..., cfg.qk_nope_dim:]
    assert torch.equal(q[..., cfg.qk_nope_dim:], raw_q)
    assert all(torch.equal(k[:, :, i, cfg.qk_nope_dim:], raw_k) for i in range(cfg.heads))


# --- spans, counts, registry ---------------------------------------------------------


def test_counts_and_spans_of_a_forward():
    """``kda.tokens`` counts rows times length a KDA layer, the MoE its
    routed rows every MoE layer; the ``kda.*`` spans open under a profiler."""
    model = load(config())
    lm = model.gemma
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(512)(TEXTS))
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.text_fwd(ids, mask)
    b, t = ids.shape
    assert lm.tally.counts == {"kda.tokens": 4 * b * t, "moe.routed_rows": 4 * b * t * 2}
    assert all(lm.tally.n_spans[f"kda.{s}"] == 4 for s in ("in", "scan", "out"))
    names = {e.name for e in prof.events()}
    assert {"mme.kda.in", "mme.kda.scan", "mme.kda.out", "mme.moe.route"} <= names
    assert int(lm.take_expert_loads().sum()) == 4 * b * t * 2


def test_registry_entry_stays_out_of_all():
    info = model_info("ColPali-Kimi-Linear-48B-A3B")
    assert (info.type, info.decoder, info.batch_size, info.hf_id) == (
        "colpali", "kimi_linear", 8, "moonshotai/Kimi-Linear-48B-A3B-Instruct")
    assert "ColPali-Kimi-Linear-48B-A3B" not in [m.name for m in get_models_to_test("all")]


def test_registry_entry_runs_through_the_cli(tmp_path):
    out = tmp_path / "kimi_linear.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models",
                    "ColPali-Kimi-Linear-48B-A3B", "--sample-size", "8", "--bootstrap-iterations", "4",
                    "--batch-size", "4", "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    assert list(df["Model"]) == ["ColPali-Kimi-Linear-48B-A3B"] and (df["Weights"] == "debug-random").all()
    for col in ("T2I_R@1_mean", "I2T_R@5_mean", "I2T_Sym_R@10_mean"):
        assert all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in df[col]), col
    model = tcli.load_model_for(model_info("ColPali-Kimi-Linear-48B-A3B"), debug=True, arch=False, seed=0,
                                device="cpu")
    assert model.multi_vector and isinstance(model.model.gemma, KimiLinearLM)


# --- the benchmark cell ----------------------------------------------------------------


@pytest.fixture
def kda_root(tmp_path):
    return make_kda_root(tmp_path)


def _run(root, trace=False, seed=2**31 + 11):
    """``harness.run``'s stages on the CPU, short of its refusal of a loaded
    JAX (this suite's conftest loads it): (correct, compared, metrics)."""
    bench = Bench(root)
    cell = bench.cell(CELL, seed, "cpu", trace)
    session = bench.driver(cell).Session(cell)
    session.warmup()
    records, window_s, profiled, trace_ = measure(session, cell, 0.3)
    r = Run(cell, session, 0.0, records, window_s, profiled, trace_, None)
    metrics = {n: bench.metric(n).read(r) for n in bench.metric_names(CELL, trace)}
    session.free()
    return (*verdict(check(session, records, cell), cell.limits), metrics)


def test_sound_run_is_correct_with_room(kda_root):
    correct, compared, _ = _run(kda_root)
    assert correct, compared
    assert set(compared) == set(LIMITS)
    for name, row in compared.items():
        assert row["value"] <= row["limit"] / 3, (name, row)


def test_control_is_not_correct(kda_root):
    bench = Bench(kda_root)
    cell = bench.cell(CELL, SEED, "cpu", False)
    driver = bench.driver(cell)
    session = driver.Session(cell)
    session.warmup()
    records = measure(session, cell, 0.2)[0]
    session.free()
    correct, compared = verdict(check(session, records, cell, driver.CONTROL), cell.limits)
    assert not correct, compared


def test_recurrence_without_its_state_is_not_correct(kda_root, monkeypatch):
    monkeypatch.setattr(tkda, "kda_plain", lambda *args, chunk=64: _no_carry(*args, chunk=4))
    correct, compared, _ = _run(kda_root)
    assert not correct, compared


def test_traced_run_reports_the_kda_metrics(kda_root):
    correct, compared, metrics = _run(kda_root, trace=True)
    assert correct, compared
    assert metrics["kda_idle_pct.late"] >= 0.0 and metrics["moe_idle_pct.late"] >= 0.0
    assert metrics["expert_load_ratio.late"] >= 1.0
    assert metrics["kda_roofline_pct.late"] is None  # no card, no device time
    assert metrics["ssm_idle_pct.late"] is None and metrics["ssm_roofline_pct.late"] is None


def test_counts_at_the_published_widths():
    """About 79 MFLOP a token a KDA layer outside the recurrence and 129 a
    MoE layer; the recurrence's work at a page batch, bound by its bytes."""
    ys = yardstick_kda
    assert ys.layer_counts(FULL) == (12, 4, 15)
    assert ys.kda_layer_flops(FULL) - ys.kda_flops(FULL) == pytest.approx(79.4e6, rel=1e-2)
    assert ys.kda_flops(FULL) == 32 * 7 * 128 * 128
    flops, nbytes = ys.kda_work(FULL, 8 * 1030)
    assert flops == 8 * 1030 * 32 * 7 * 128 * 128
    assert nbytes == 8 * 1030 * 32 * (4 * 128 * 2 + 128 * 4 + 4)
    assert nbytes / 3.35e12 > flops / 989e12
    flops, nbytes = ys.expert_work(FULL, 8 * 1030)
    assert flops == 8 * 1030 * 8 * 2 * 3 * 2304 * 1024
    assert nbytes == (256 * 3 * 2304 * 1024 + 2 * 8 * 1030 * 8 * 2304) * 2
    moe = 2 * 2304 * 256 + 8 * 2 * 3 * 2304 * 1024 + 2 * 3 * 2304 * 1024
    assert moe == pytest.approx(129e6, rel=1e-2)
    pairs = 1030 * 1031 // 2
    assert ys.attention_work(FULL, [1030])[0] == 4 * 2.0 * pairs * 32 * (192 + 128)


def test_kda_readers_read_nothing_without_their_layer():
    """Both new readers return None for a run whose program has no KDA layer
    (a parent, or another model's cell), and the roofline reads the kernel's
    own name."""
    bench = Bench(ROOT)
    roof, idle = bench.metric("kda_roofline_pct.late"), bench.metric("kda_idle_pct.late")

    class Trace:
        window_s, busy_s = 1.0, 0.5
        kernels = {"void (anonymous namespace)::kda_scan_kernel<__nv_bfloat16>(Args)": 0.01,
                   "void at::native::kda_scan_kernel_other<float>": 1.0}
        idle = {"mme.kda.in": 0.01, "mme.kernel.kda_scan": 0.02, "mme.moe.route": 0.5}

        def kernel_seconds(self, names):
            from perfbench.trace import Trace as Real

            return Real.kernel_seconds(self, names)

    class Session:
        class lm:
            class tally:
                n_spans = {"kda.scan": 3}

        @staticmethod
        def required(_):
            return {"kda": [(1e9, 1e9)]}

    class Run:
        trace, session, profiled = Trace(), Session(), []
        peaks = {"bf16_flops": 1e15, "bytes": 1e12}

    assert idle.read(Run()) == pytest.approx(3.0)
    assert roof.read(Run()) == pytest.approx(100.0 * 1e-3 / 0.01)
    Session.required = staticmethod(lambda _: {"experts": []})
    Session.lm.tally.n_spans = {}
    assert roof.read(Run()) is None and idle.read(Run()) is None
