"""Granite-4.0-H's hybrid decoder (``models/granite.py``) that ColPali runs
for Granite-4.0-H-Small's language model, its state-space scan
(``ops/ssm.py``), its router (``ops/moe.py:route_softmax``), its converter,
its registry entry and its benchmark cell, on the CPU at a small size: width
64, 3 Mamba-2 layers (16 heads of 8, state 16, chunk 8) and one attention
layer, 8 experts at top-2 and a shared one, f32, weights drawn from a seed.

- The port's ColPali in f32 against the plain reference
  (``perfbench/reference/colpali_hybrid.py``) on the same HF-layout weights:
  1e-5 relative, as ``test_torch_deepseek.py`` holds the DeepSeek variant
  (f32 products summed in other orders through the vision tower and 4
  decoder layers: the port's chunked scan against the reference's token
  loop, einsum attention against per-head products, grouped rows against
  one masked product an expert); the expert choices equal.
- The plain reference's language model against ``transformers``'
  ``GraniteMoeHybridModel`` (its ``torch_forward``) on the same weights:
  1e-5 relative, the same f32 equations in another order.
- The plain scan against a float64 token loop at lengths that are and are
  not whole chunks: 1e-5 of the output's largest magnitude (f32 decays and
  sums over a chunk's cumulative log decays).
- The decoder's final hidden states against the reference's on the same
  inputs, 1e-6 relative (the two read 1.2e-7 apart): a scan that drops the
  state carried between chunks (2.6e-3 apart), one without the D skip
  (0.32) and one with its decays rounded to bf16 (1.2e-5) each fail it.
  ``perfbench/faults.py``'s stand-ins for the three faults, which the
  benchmark's check is read with on the card, compute the faults they name.
- Right-padded rows keep their valid outputs; the router against
  ``GraniteMoeHybridTopKGating``; the DeepSeek router's outputs bit for bit
  those of its code before the Granite router was added.
- The benchmark cell's toy (``granite_tiny.py``) through the harness: a
  sound run is ``correct`` with room, the fp8 control and a scan without the
  D skip are not; a traced run reads the new per-layer metrics.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models.arch import colpali_word_tokenizer, full_colpali_granite_config
from multimodal_embedding_tpu_torch.models.colpali import (
    LM_PREFIX,
    ColPaliConfig,
    colpali_granite_from_hf,
    debug_colpali_config,
)
from multimodal_embedding_tpu_torch.models.granite import GraniteLM, granite_config_from_hf
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test, model_info
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from multimodal_embedding_tpu_torch.ops import ssm, ssm_cuda
from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn
from perfbench import weights_hybrid, yardstick_hybrid
from perfbench.harness import ROOT, Bench, Run, check, measure, verdict
from perfbench.reference import colpali_hybrid as ref
from tests.granite_tiny import CELL, LIMITS, config, make_hybrid_root
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
RTOL_LM = 1e-6
SEED = 2**31 + 7
TEXTS = ["a red dog on the left", "two cats", "the bus is near the window in the picture and a man crosses"]
FULL = json.loads((ROOT / "perfbench" / "configs" / "colpali-granite-4.0-h-small.json").read_text())


def colpali_cfg(cfg: dict) -> ColPaliConfig:
    base = debug_colpali_config()
    return ColPaliConfig(vision=base.vision, gemma=granite_config_from_hf(cfg), embedding_dim=cfg["embedding_dim"])


def draw(cfg: dict, seed: int = SEED):
    return lambda part: weights_hybrid.draw(cfg, part, seed, device="cpu", dtype=torch.float32)


def load(cfg: dict, seed: int = SEED):
    d = draw(cfg, seed)
    return colpali_granite_from_hf((d(p) for p in weights_hybrid.parts(cfg)), colpali_cfg(cfg),
                                   cfg["image_suffix_ids"], dtype=torch.float32)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


# --- configuration -------------------------------------------------------------


def test_debug_config_is_the_tests_size():
    lm = debug_colpali_config(decoder="granite").gemma
    assert (lm.dim, lm.mamba_layers, lm.layers, lm.n_experts, lm.top_k, lm.state, lm.ssm_head_dim, lm.chunk) == (
        64, 3, 4, 8, 2, 16, 8, 8)
    assert lm == granite_config_from_hf(config())


def test_arch_config_is_the_catalog_row():
    """The registry's full-width model and the benchmark's configuration file
    name the same language model, at the published widths and depth."""
    full = full_colpali_granite_config()
    lm = full.gemma
    assert granite_config_from_hf(FULL) == lm
    assert (lm.layers, lm.mamba_layers, lm.n_experts, lm.top_k, lm.vocab_size) == (40, 36, 72, 10, 100352)
    assert [i for i, k in enumerate(lm.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert (lm.ssm_heads, lm.ssm_head_dim, lm.state, lm.conv_width, lm.d_inner) == (128, 64, 128, 4, 8192)
    assert (lm.heads, lm.kv_heads, lm.head_dim, lm.attention_multiplier) == (32, 8, 128, 1 / 128)
    vc = FULL["vision_config"]
    assert (vc["hidden_size"], vc["num_hidden_layers"], vc["image_size"]) == (full.vision.dim, full.vision.layers,
                                                                               full.vision.image_size)
    assert FULL["reduced"] == []


@pytest.mark.parametrize("key, value", [("position_embedding_type", "rope"), ("mamba_n_groups", 2),
                                        ("attention_bias", True), ("num_local_experts", 0),
                                        ("layer_types", ["mamba", "linear", "mamba", "mamba"])])
def test_config_refuses_what_it_does_not_run(key, value):
    cfg = config()
    cfg[key] = value
    with pytest.raises(ValueError):
        granite_config_from_hf(cfg)


def test_weights_draw_the_mamba2_initialiser():
    """A in [1, 16], dt = softplus(dt_bias) in [0.001, 0.1], the conv in
    +-1/2, D ones; the same part from the same seed twice is the same."""
    cfg = config()
    part = draw(cfg)("layer.0")
    m = f"{LM_PREFIX}.layers.0.mamba"
    a = torch.exp(part[f"{m}.A_log"])
    dt = torch.nn.functional.softplus(part[f"{m}.dt_bias"])
    assert bool(((a >= 1) & (a <= 16)).all()) and float(a.max() - a.min()) > 5
    assert bool(((dt >= 0.001 - 1e-7) & (dt <= 0.1 + 1e-6)).all())
    assert float(part[f"{m}.conv1d.weight"].abs().max()) <= 0.5 and float(part[f"{m}.conv1d.weight"].std()) > 0.2
    assert torch.equal(part[f"{m}.D"], torch.ones(16))
    assert all(torch.equal(v, draw(cfg)("layer.0")[k]) for k, v in part.items())
    assert f"{LM_PREFIX}.layers.1.self_attn.k_proj.weight" in draw(cfg)("layer.1")


# --- the port against the references --------------------------------------------


@pytest.mark.parametrize("seed", [SEED, 5])
def test_port_matches_the_plain_reference_in_f32(seed):
    cfg = config()
    model = load(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    imgs = [torch.randint(0, 256, (3, 40, 50), dtype=torch.uint8, generator=gen) for _ in range(3)]
    want = ref.embed(imgs, TEXTS, draw(cfg, seed), cfg, "f32", "cpu")
    pre = make_preprocess_fn(model_info("ColPali-Granite-4.0-H-Small").preprocess.__class__(
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


def hf_model(seed: int = 0):
    """``transformers``' ``GraniteMoeHybridModel`` at the tests' size, eager
    attention, its Mamba-2 layers on ``torch_forward``."""
    from transformers import GraniteMoeHybridConfig, GraniteMoeHybridModel

    cfg = config()
    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "rms_norm_eps", "embedding_multiplier", "residual_multiplier",
            "attention_multiplier", "num_local_experts", "num_experts_per_tok", "shared_intermediate_size",
            "position_embedding_type", "layer_types", "mamba_n_heads", "mamba_n_groups", "mamba_d_state",
            "mamba_d_head", "mamba_d_conv", "mamba_expand", "mamba_chunk_size", "mamba_conv_bias", "mamba_proj_bias")
    torch.manual_seed(seed)
    hf_cfg = GraniteMoeHybridConfig(**{k: cfg[k] for k in keys}, attn_implementation="eager")
    return GraniteMoeHybridModel(hf_cfg).eval()


def test_reference_lm_matches_transformers_granite():
    cfg = config()
    hf = hf_model()
    sd = {}
    for i in range(cfg["num_hidden_layers"]):
        sd.update(draw(cfg)(f"layer.{i}"))
    sd.update(draw(cfg)("misc"))
    prefix = LM_PREFIX + "."
    hf.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    x = torch.randn(2, 19, cfg["hidden_size"], generator=torch.Generator().manual_seed(3)) * 0.1
    mask = torch.tensor([[1] * 19, [1] * 13 + [0] * 6])
    with torch.no_grad():
        want = hf(inputs_embeds=x, attention_mask=mask).last_hidden_state
    h = x * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        h = ref.decoder_layer(h, sd, i, cfg, "f32", mask)[0]
    got = ref.rms_norm(h, sd[f"{LM_PREFIX}.norm.weight"], cfg["rms_norm_eps"])
    valid = mask.bool()
    assert rel(got[valid], want[valid]) < RTOL


def test_converter_reads_the_hf_key_layout():
    """Every HF tensor lands where the port reads it: a state dict made by
    ``GraniteMoeHybridModel`` itself, under ColPali's prefix, gives the
    port's language model the HF model's hidden states."""
    cfg = config()
    hf = hf_model(1)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(torch.randn_like(p) * 0.02)  # no norm weight stays at 1, no expert at HF's init
    sd = {f"{LM_PREFIX}.{k}": v for k, v in hf.state_dict().items()}
    other = draw(cfg)
    sd.update({k: v for k, v in other("misc").items() if not k.startswith(LM_PREFIX)})
    model = colpali_granite_from_hf([other("vision"), sd], colpali_cfg(cfg), cfg["image_suffix_ids"],
                                    dtype=torch.float32)
    lm = model.gemma
    assert isinstance(lm, GraniteLM)
    moe = hf.layers[2].block_sparse_moe
    assert torch.equal(lm.layers[2].mlp["w13"], moe.input_linear.weight)
    assert torch.equal(lm.layers[2].mlp["router"], moe.router.layer.weight)
    assert torch.equal(lm.layers[0].mamba["conv_w"], hf.layers[0].mamba.conv1d.weight)
    ids = torch.tensor([[5, 9, 100, 7, 3, 0, 11, 12, 13, 14], [8, 1, 2, 4, 6, 0, 0, 0, 0, 0]])
    mask = torch.tensor([[1] * 10, [1] * 5 + [0] * 5])
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = lm(lm.embed_tokens(ids), attn_mask=mask)
    valid = mask.bool()
    assert rel(got[valid], want[valid]) < RTOL


def test_converter_refuses_a_model_left_half_filled():
    cfg = config()
    d = draw(cfg)
    with pytest.raises(ValueError, match="not filled"):
        colpali_granite_from_hf([d("vision"), d("misc"), d("layer.0")], colpali_cfg(cfg), cfg["image_suffix_ids"],
                                dtype=torch.float32)


# --- the scan ----------------------------------------------------------------------


def _loop64(x, dt, a, bm, cm, d):
    """The recurrence token by token in float64."""
    b, t, h, p = x.shape
    x, dt, a, bm, cm, d = (v.double() for v in (x, dt, a, bm, cm, d))
    state = torch.zeros(b, h, p, bm.shape[-1], dtype=torch.float64)
    ys = []
    for i in range(t):
        state = torch.exp(dt[:, i] * a)[..., None, None] * state + (dt[:, i, :, None] * x[:, i])[..., None] \
            * bm[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, i]))
    return torch.stack(ys, dim=1) + d[:, None] * x


def _scan_inputs(t: int, seed: int = 0, b: int = 2, h: int = 3, p: int = 4, n: int = 5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, h, p, generator=g), torch.rand(b, t, h, generator=g) * 0.2,
            -1 - 15 * torch.rand(h, generator=g), torch.randn(b, t, n, generator=g), torch.randn(b, t, n, generator=g),
            torch.randn(h, generator=g))


@pytest.mark.parametrize("t", [1, 5, 8, 16, 19, 33])
def test_plain_scan_matches_a_float64_loop(t):
    args = _scan_inputs(t, seed=t)
    want = _loop64(*args)
    got = ssm.scan(*args, chunk=8)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_plain_scan_carries_the_state_across_chunks():
    """The whole sequence at chunk 4 equals chunk 32 (one chunk), and both
    differ from the chunks scanned apart."""
    args = _scan_inputs(24, seed=3)
    whole, small = ssm.scan_plain(*args, chunk=32), ssm.scan_plain(*args, chunk=4)
    assert float((whole - small).abs().max()) <= 1e-5 * float(whole.abs().max())
    x, dt, a, bm, cm, d = args
    apart = torch.cat([ssm.scan_plain(x[:, s:s + 4], dt[:, s:s + 4], a, bm[:, s:s + 4], cm[:, s:s + 4], d, chunk=4)
                       for s in range(0, 24, 4)], dim=1)
    assert float((apart - whole).abs().max()) > 1e-2 * float(whole.abs().max())


def test_scan_wrapper_refuses_before_launch():
    """The kernel's wrapper takes only card tensors of the shapes and strides
    it reads; the dispatcher sends CPU tensors to the plain version."""
    x, dt, a, bm, cm, d = _scan_inputs(6)
    with pytest.raises(ValueError, match="cuda"):
        ssm_cuda.scan(x, dt, a, bm, cm, d)
    assert ssm.scan(x, dt, a, bm, cm, d, chunk=4).device.type == "cpu"


# --- planted faults -----------------------------------------------------------------

_PLAIN = ssm.scan_plain  # the sound scan, which each fault below wraps


def _drop_carry(x, dt, a, bm, cm, d, *, chunk):
    """The scan with each chunk started from a zero state."""
    return torch.cat([_PLAIN(x[:, s:s + chunk], dt[:, s:s + chunk], a, bm[:, s:s + chunk], cm[:, s:s + chunk], d,
                             chunk=chunk) for s in range(0, x.shape[1], chunk)], dim=1)


def _no_skip(x, dt, a, bm, cm, d, *, chunk):
    return _PLAIN(x, dt, a, bm, cm, torch.zeros_like(d), chunk=chunk)


def _bf16_decays(x, dt, a, bm, cm, d, *, chunk):
    """The recurrence with each decay exp(dt A) rounded to bf16."""
    b, t, h, p = x.shape
    state = x.new_zeros(b, h, p, bm.shape[-1])
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a).bfloat16().float()
        state = decay[..., None, None] * state + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, i]))
    return torch.stack(ys, dim=1) + d[:, None] * x


def _lm_gap(monkeypatch, fault) -> float:
    """The port's final hidden states against the reference's on the same
    caption embeddings, relative, with ``fault`` in place of the scan."""
    if fault is not None:
        monkeypatch.setattr(ssm, "scan_plain", fault)
    cfg = config()
    model = load(cfg)
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(cfg["vocab_size"])(TEXTS))
    d = draw(cfg)
    with torch.no_grad():
        got = model.gemma(model.gemma.embed_tokens(ids), attn_mask=mask)
        h = model.gemma.embed_tokens(ids) * cfg["embedding_multiplier"]
        for i in range(cfg["num_hidden_layers"]):
            h = ref.decoder_layer(h, d(f"layer.{i}"), i, cfg, "f32", mask)[0]
        want = ref.rms_norm(h, d("misc")[f"{LM_PREFIX}.norm.weight"], cfg["rms_norm_eps"])
    valid = mask.bool()
    return rel(got[valid], want[valid])


def test_decoder_matches_the_reference_on_the_same_inputs(monkeypatch):
    assert _lm_gap(monkeypatch, None) < RTOL_LM


@pytest.mark.parametrize("fault", [_drop_carry, _no_skip, _bf16_decays], ids=["drop_carry", "no_skip", "bf16_decays"])
def test_planted_scan_fault_fails_the_compare(monkeypatch, fault):
    assert _lm_gap(monkeypatch, fault) > RTOL_LM


@pytest.mark.parametrize("name", ["scan_no_carry", "scan_no_skip", "scan_bf16_decays"])
def test_benchmark_faults_are_the_faults_they_name(name):
    """``perfbench/faults.py``'s stand-ins on the CPU at 37 tokens (not whole
    stages): each within 1e-5 of its largest output (f32 sums in other
    orders) of the fault above that it names, the state zeroed every 16
    tokens for ``scan_no_carry``."""
    from perfbench import faults

    gen = torch.Generator().manual_seed(5)
    x = torch.nn.functional.silu(torch.randn(2, 37, 4, 8, generator=gen))
    dt = torch.nn.functional.softplus(torch.randn(2, 37, 4, generator=gen) - 4)
    a, d = -(1 + 15 * torch.rand(4, generator=gen)), torch.rand(4, generator=gen)
    bm, cm = torch.randn(2, 37, 16, generator=gen), torch.randn(2, 37, 16, generator=gen)
    want = {"scan_no_carry": lambda: _drop_carry(x, dt, a, bm, cm, d, chunk=faults.STAGE),
            "scan_no_skip": lambda: _no_skip(x, dt, a, bm, cm, d, chunk=8),
            "scan_bf16_decays": lambda: _bf16_decays(x, dt, a, bm, cm, d, chunk=8)}[name]()
    got = faults.FAULTS[name](x, dt, a, bm, cm, d, chunk=8)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((got - _PLAIN(x, dt, a, bm, cm, d, chunk=8)).abs().max()) > 1e-4 * float(want.abs().max())


def test_right_padded_rows_keep_their_valid_outputs():
    """A caption's valid outputs alone and in a batch padded past it agree
    (the causal scan, conv and attention never read a later pad)."""
    model = load(config())
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(512)(TEXTS))
    with torch.no_grad():
        batch = model.text_fwd(ids, mask)
        for row in range(len(TEXTS)):
            n = int(mask[row].sum())
            alone = model.text_fwd(ids[row:row + 1, :n], mask[row:row + 1, :n])
            assert rel(batch[row, :n], alone[0]) < RTOL_LM
            assert not batch[row, n:].any()


# --- routers ------------------------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [1, 37, 200])
def test_router_matches_granite_topk_gating(n_tokens):
    from transformers.models.granitemoehybrid.modeling_granitemoehybrid import GraniteMoeHybridTopKGating

    gen = torch.Generator().manual_seed(n_tokens)
    gating = GraniteMoeHybridTopKGating(64, 8, 2)
    with torch.no_grad():
        gating.layer.weight.copy_(torch.randn(8, 64, generator=gen))
    x = torch.randn(n_tokens, 64, generator=gen)
    with torch.no_grad():
        index_sorted, batch_index, batch_gates, expert_size, _ = gating(x)
        r = tmoe.route_softmax(x, gating.layer.weight, top_k=2)
    assert torch.equal(r.counts, torch.tensor(expert_size))
    assert torch.equal(r.token.sort().values, batch_index.sort().values)
    flat = r.experts.reshape(-1)
    assert torch.equal(flat[index_sorted].view(-1), flat.sort().values)  # the same choices, grouped by expert
    want = torch.zeros(n_tokens, 8).index_put_((batch_index, flat[index_sorted]), batch_gates)
    got = torch.zeros(n_tokens, 8).scatter_(1, r.experts, r.weights)
    assert float((got - want).abs().max()) < 1e-6


def _route_before(x, w_router, bias, *, top_k, scale, normalize):
    """``ops/moe.py:route`` as written before the Granite router was added."""
    n_experts = w_router.shape[0]
    scores = torch.sigmoid(x.float() @ w_router.float().T)
    experts = torch.topk(scores + bias.float(), top_k, dim=-1, sorted=False).indices
    weights = scores.gather(1, experts)
    if normalize:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * scale
    flat_sorted, order = torch.sort(experts.reshape(-1), stable=True)
    ids = torch.arange(n_experts, device=x.device, dtype=flat_sorted.dtype)
    ends = torch.searchsorted(flat_sorted, ids, right=True)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    rows = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
    return tmoe.Routing(experts, order // top_k, rows.view(-1, top_k), ends.to(torch.int32), counts, weights)


@pytest.mark.parametrize("n_tokens, k", [(1, 2), (37, 6), (200, 6)])
def test_deepseek_router_is_unchanged(n_tokens, k):
    gen = torch.Generator().manual_seed(n_tokens)
    x = torch.randn(n_tokens, 32, generator=gen)
    w, bias = torch.randn(16, 32, generator=gen), torch.randn(16, generator=gen) * 0.1
    got = tmoe.route(x, w, bias, top_k=k, scale=2.446, normalize=True)
    want = _route_before(x, w, bias, top_k=k, scale=2.446, normalize=True)
    for field in ("experts", "token", "rows", "ends", "counts", "weights"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


# --- spans, counts, registry ---------------------------------------------------------


def test_counts_and_spans_of_a_forward():
    """``ssm.tokens`` counts rows times length a Mamba-2 layer, the MoE its
    routed rows every layer; the ``ssm.*`` spans open under a profiler."""
    model = load(config())
    lm = model.gemma
    ids, mask = (torch.as_tensor(v).long() for v in colpali_word_tokenizer(512)(TEXTS))
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.text_fwd(ids, mask)
    b, t = ids.shape
    assert lm.tally.counts == {"ssm.tokens": 3 * b * t, "moe.routed_rows": 4 * b * t * 2}
    assert all(lm.tally.n_spans[f"ssm.{s}"] == 3 for s in ("in", "scan", "out"))
    names = {e.name for e in prof.events()}
    assert {"mme.ssm.in", "mme.ssm.scan", "mme.ssm.out", "mme.moe.route"} <= names
    assert int(lm.take_expert_loads().sum()) == 4 * b * t * 2


def test_registry_entry_stays_out_of_all():
    info = model_info("ColPali-Granite-4.0-H-Small")
    assert (info.type, info.decoder, info.batch_size, info.hf_id) == ("colpali", "granite", 8,
                                                                       "ibm-granite/granite-4.0-h-small")
    assert "ColPali-Granite-4.0-H-Small" not in [m.name for m in get_models_to_test("all")]


def test_registry_entry_runs_through_the_cli(tmp_path):
    out = tmp_path / "granite.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models",
                    "ColPali-Granite-4.0-H-Small", "--sample-size", "8", "--bootstrap-iterations", "4",
                    "--batch-size", "4", "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    assert list(df["Model"]) == ["ColPali-Granite-4.0-H-Small"] and (df["Weights"] == "debug-random").all()
    for col in ("T2I_R@1_mean", "I2T_R@5_mean", "I2T_Sym_R@10_mean"):
        assert all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in df[col]), col
    model = tcli.load_model_for(model_info("ColPali-Granite-4.0-H-Small"), debug=True, arch=False, seed=0,
                                device="cpu")
    assert model.multi_vector and isinstance(model.model.gemma, GraniteLM)


# --- the benchmark cell ----------------------------------------------------------------


@pytest.fixture
def hybrid_root(tmp_path):
    return make_hybrid_root(tmp_path)


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


def test_sound_run_is_correct_with_room(hybrid_root):
    correct, compared, _ = _run(hybrid_root)
    assert correct, compared
    assert set(compared) == set(LIMITS)
    for name, row in compared.items():
        assert row["value"] <= row["limit"] / 3, (name, row)


def test_control_is_not_correct(hybrid_root):
    bench = Bench(hybrid_root)
    cell = bench.cell(CELL, SEED, "cpu", False)
    driver = bench.driver(cell)
    session = driver.Session(cell)
    session.warmup()
    records = measure(session, cell, 0.2)[0]
    session.free()
    correct, compared = verdict(check(session, records, cell, driver.CONTROL), cell.limits)
    assert not correct, compared


def test_scan_without_the_skip_is_not_correct(hybrid_root, monkeypatch):
    monkeypatch.setattr(ssm, "scan_plain", _no_skip)
    correct, compared, _ = _run(hybrid_root)
    assert not correct, compared


def test_traced_run_reports_the_ssm_metrics(hybrid_root):
    correct, compared, metrics = _run(hybrid_root, trace=True)
    assert correct, compared
    assert metrics["ssm_idle_pct.late"] >= 0.0 and metrics["moe_idle_pct.late"] >= 0.0
    assert metrics["expert_load_ratio.late"] >= 1.0
    assert metrics["ssm_roofline_pct.late"] is None  # no card, no device time


def test_counts_at_the_published_widths():
    """17.0 GFLOP a token through the language model and the head; the
    scan's work at a page batch, bound by its 276 MB."""
    assert yardstick_hybrid.token_flops(FULL) == pytest.approx(16.97e9, rel=2e-3)
    assert yardstick_hybrid.scan_flops(FULL) == 128 * (5 * 64 * 128 + 3 * 64)
    flops, nbytes = yardstick_hybrid.ssm_work(FULL, 8 * 1030)
    assert flops == 8 * 1030 * 128 * (5 * 64 * 128 + 3 * 64)
    assert nbytes == 8 * 1030 * (2 * 8192 + 128 + 2 * 128) * 2
    flops, nbytes = yardstick_hybrid.expert_work(FULL, 8 * 1030)
    assert flops == 8 * 1030 * 10 * 2 * 3 * 4096 * 768
    assert nbytes == (72 * 3 * 4096 * 768 + 2 * 8 * 1030 * 10 * 4096) * 2
    pairs = 1030 * 1031 // 2
    assert yardstick_hybrid.attention_work(FULL, [1030])[0] == 4 * 4.0 * pairs * 32 * 128


def test_ssm_readers_read_nothing_without_their_layer():
    """Both new readers return None for a run whose program has no scan (a
    parent, or another model's cell), and the roofline reads the kernel's
    own name."""
    bench = Bench(ROOT)
    roof, idle = bench.metric("ssm_roofline_pct.late"), bench.metric("ssm_idle_pct.late")

    class Trace:
        window_s, busy_s = 1.0, 0.5
        kernels = {"void (anonymous namespace)::ssm_scan_kernel<__nv_bfloat16, 128>(Args)": 0.01,
                   "void at::native::tensor_kernel_scan_innermost_dim<float>": 1.0}
        idle = {"mme.ssm.in": 0.01, "mme.kernel.ssm_scan": 0.02, "mme.moe.route": 0.5}

        def kernel_seconds(self, names):
            from perfbench.trace import Trace as Real

            return Real.kernel_seconds(self, names)

    class Session:
        class lm:
            class tally:
                n_spans = {"ssm.scan": 3}

        @staticmethod
        def required(_):
            return {"ssm": [(1e9, 1e9)]}

    class Run:
        trace, session, profiled = Trace(), Session(), []
        peaks = {"bf16_flops": 1e15, "bytes": 1e12}

    assert idle.read(Run()) == pytest.approx(3.0)
    assert roof.read(Run()) == pytest.approx(100.0 * 1e-3 / 0.01)
    Session.required = staticmethod(lambda _: {"experts": []})
    Session.lm.tally.n_spans = {}
    assert roof.read(Run()) is None and idle.read(Run()) is None


def test_limits_sit_between_readings():
    """Each limit of the cell lies between the port's largest reading and the
    fp8 control's smallest, with room on both sides."""
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         "colpali-granite-4.0-h-small.coco-maxsim-hybrid.json").read_text())
    names = [k for k in limits if not k.startswith("_")]
    assert set(names) == set(LIMITS)
    for name in names:
        row = limits[name]
        assert row["lower"] < row["limit"] < row["upper"], name
