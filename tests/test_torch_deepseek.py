"""The DeepSeek-V3 decoder (``models/deepseek.py``) that ColPali runs for
Kimi-VL-A3B's language model, its grouped expert dispatch
(``ops/moe.py``), its converter and its registry entry, on the CPU at a
small size: width 64, one dense layer then 2 MoE layers of 8 experts, top-2,
2 shared.

- The port's ColPali in f32 against the plain reference
  (``perfbench/reference/colpali_moe.py``) on the same HF-layout weights:
  1e-5 relative, f32 products summed in another order (the port's einsum
  attention and grouped rows against the reference's per-head matmuls and
  one masked product an expert) through 2 + 3 layers; the expert choices
  equal.
- The plain reference's language model against ``transformers``'
  ``DeepseekV3Model`` on the same weights: 1e-5 relative, the same f32
  equations in another order.
- The sorted grouped dispatch against a loop over the experts (the
  published ``DeepseekV3MoE.moe``): the same routing, the output within
  1e-6 relative (f32 sums in another order).
- The on-device converter against the HF key layout, and the registry entry
  through the CLI's load path.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models.arch import colpali_word_tokenizer, full_colpali_deepseek_config
from multimodal_embedding_tpu_torch.models.colpali import (
    LM_PREFIX,
    ColPaliConfig,
    colpali_deepseek_from_hf,
    debug_colpali_config,
)
from multimodal_embedding_tpu_torch.models.deepseek import DeepseekLM, deepseek_config_from_hf
from multimodal_embedding_tpu_torch.models.registry import get_models_to_test, model_info
from multimodal_embedding_tpu_torch.ops import moe as tmoe
from multimodal_embedding_tpu_torch.ops.preprocess import make_preprocess_fn
from multimodal_embedding_tpu_torch.utils.profiling import Tally
from perfbench import weights_moe
from perfbench.harness import ROOT
from perfbench.reference import colpali_moe as ref
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
SEED = 2**31 + 7
TEXTS = ["a red dog on the left", "two cats", "the bus is near the window in the picture"]


def tiny_config() -> dict:
    """The benchmark's configuration file cut to the tests' size."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "colpali-kimi-vl-a3b.json").read_text())
    cfg.update(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, rope_theta=10000.0, embedding_dim=16)
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_hidden_layers=2,
                                image_size=28)
    cfg["preprocess"]["image_size"] = 28
    return cfg


def colpali_cfg(cfg: dict) -> ColPaliConfig:
    base = debug_colpali_config()
    return ColPaliConfig(vision=base.vision, gemma=deepseek_config_from_hf(cfg), embedding_dim=cfg["embedding_dim"])


def draw(cfg: dict, seed: int = SEED):
    return lambda part: weights_moe.draw(cfg, part, seed, device="cpu", dtype=torch.float32)


def load(cfg: dict, seed: int = SEED):
    d = draw(cfg, seed)
    return colpali_deepseek_from_hf((d(p) for p in weights_moe.parts(cfg)), colpali_cfg(cfg), cfg["image_suffix_ids"],
                                    dtype=torch.float32)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def test_debug_config_is_the_tests_size():
    lm = debug_colpali_config(decoder="deepseek").gemma
    assert (lm.dim, lm.layers, lm.first_dense, lm.n_experts, lm.top_k, lm.n_shared) == (64, 3, 1, 8, 2, 2)
    assert lm == deepseek_config_from_hf(tiny_config())


def test_arch_config_is_the_catalog_row():
    """The registry's full-width model and the benchmark's configuration file
    name the same language model, and the file's vision side is the arch
    ColPali's."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "colpali-kimi-vl-a3b.json").read_text())
    full = full_colpali_deepseek_config()
    assert deepseek_config_from_hf(cfg) == full.gemma
    assert (full.gemma.layers, full.gemma.n_experts, full.gemma.top_k, full.gemma.n_shared) == (27, 64, 6, 2)
    vc = cfg["vision_config"]
    assert (vc["hidden_size"], vc["num_hidden_layers"], vc["image_size"]) == (full.vision.dim, full.vision.layers,
                                                                               full.vision.image_size)
    assert cfg["reduced"] == []


@pytest.mark.parametrize("key, value", [("q_lora_rank", 1536), ("n_group", 8), ("scoring_func", "softmax"),
                                        ("rope_scaling", {"type": "yarn"})])
def test_config_refuses_what_it_does_not_run(key, value):
    cfg = tiny_config()
    cfg[key] = value
    with pytest.raises(ValueError):
        deepseek_config_from_hf(cfg)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_port_matches_the_plain_reference_in_f32(seed):
    cfg = tiny_config()
    model = load(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    imgs = [torch.randint(0, 256, (3, 40, 50), dtype=torch.uint8, generator=gen) for _ in range(3)]
    want = ref.embed(imgs, TEXTS, draw(cfg, seed), cfg, "f32", "cpu")
    pre = make_preprocess_fn(model_info("ColPali-KimiVL-A3B").preprocess.__class__(
        image_size=28, resize_mode="exact", interpolation="bicubic", mean=(0.5,) * 3, std=(0.5,) * 3),
        40, 50, device="cpu", input_format="nchw")
    model.gemma.route_sink = []
    pages = model.image_fwd(torch.cat([pre(im[None]) for im in imgs]))
    ids, mask = colpali_word_tokenizer(cfg["vocab_size"])(TEXTS)
    assert np.array_equal(ids, ref.tokenize_queries(TEXTS, cfg["vocab_size"])[0].numpy())
    queries = model.text_fwd(torch.as_tensor(ids).long(), torch.as_tensor(mask))
    assert rel(pages, want["pages"]) < RTOL and rel(queries, want["queries"]) < RTOL
    assert float(queries.abs().sum()) > 0 and torch.equal(queries[1, int(mask[1].sum()):], torch.zeros_like(
        queries[1, int(mask[1].sum()):]))
    page_routes, query_routes = (torch.stack(call, dim=1).sort(dim=-1).values for call in model.gemma.route_sink)
    assert torch.equal(page_routes.view(want["page_routes"].shape), want["page_routes"])
    assert torch.equal(query_routes.view(want["query_routes"].shape), want["query_routes"])
    assert not want["page_margin"].any()


def hf_config():
    """``transformers``' config of the tests' language model."""
    from transformers import DeepseekV3Config

    cfg = tiny_config()
    keys = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
            "num_attention_heads", "n_shared_experts", "n_routed_experts", "routed_scaling_factor", "kv_lora_rank",
            "q_lora_rank", "qk_rope_head_dim", "v_head_dim", "qk_nope_head_dim", "n_group", "topk_group",
            "num_experts_per_tok", "first_k_dense_replace", "norm_topk_prob", "rms_norm_eps", "rope_theta")
    return DeepseekV3Config(**{k: cfg[k] for k in keys}, num_key_value_heads=cfg["num_attention_heads"],
                            rope_scaling=None, attention_bias=False, max_position_embeddings=64,
                            attn_implementation="eager")


def test_reference_lm_matches_transformers_deepseek_v3():
    from transformers import DeepseekV3Model

    cfg = tiny_config()
    hf_cfg = hf_config()
    torch.manual_seed(0)
    hf = DeepseekV3Model(hf_cfg).eval()
    sd = {}
    for i in range(cfg["num_hidden_layers"]):
        sd.update(draw(cfg)(f"layer.{i}"))
    sd.update(draw(cfg)("misc"))
    prefix = LM_PREFIX + "."
    hf.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    x = torch.randn(2, 9, cfg["hidden_size"], generator=torch.Generator().manual_seed(3))
    mask = torch.tensor([[1] * 9, [1] * 6 + [0] * 3])
    with torch.no_grad():
        want = hf(inputs_embeds=x, attention_mask=mask).last_hidden_state
    h = x
    for i in range(cfg["num_hidden_layers"]):
        h = ref.decoder_layer(h, sd, i, cfg, "f32", mask)[0]
    got = ref.rms_norm(h, sd[f"{LM_PREFIX}.norm.weight"], cfg["rms_norm_eps"])
    valid = mask.bool()
    assert rel(got[valid], want[valid]) < RTOL


def _loop_moe(x, router, w13, w2, top_k, scale):
    """The published loop (``DeepseekV3MoE.moe``): each expert over the rows
    routed to it, the weighted outputs added into the tokens."""
    r = tmoe.route(x, router["w"], router["bias"], top_k=top_k, scale=scale, normalize=True)
    out = torch.zeros_like(x)
    for e in range(w13.shape[0]):
        tok, slot = torch.where(r.experts == e)
        if tok.numel():
            gate, up = (x[tok] @ w13[e].T).chunk(2, dim=-1)
            y = (torch.nn.functional.silu(gate) * up) @ w2[e].T
            out.index_add_(0, tok, y * r.weights[tok, slot, None])
    return out, r


@pytest.mark.parametrize("n_tokens", [1, 37, 200])
def test_grouped_dispatch_matches_a_loop_over_the_experts(n_tokens):
    gen = torch.Generator().manual_seed(n_tokens)
    e, d, i, k = 8, 64, 32, 2
    x = torch.randn(n_tokens, d, generator=gen)
    router = {"w": torch.randn(e, d, generator=gen) * 0.1, "bias": torch.randn(e, generator=gen) * 0.1}
    w13, w2 = torch.randn(e, 2 * i, d, generator=gen) * 0.1, torch.randn(e, d, i, generator=gen) * 0.1
    tally = Tally()
    loads = torch.zeros(e, dtype=torch.int64)
    got, r = tmoe.moe(x, router, w13, w2, None, top_k=k, scale=2.446, normalize=True, tally=tally, loads=loads)
    want, r_loop = _loop_moe(x, router, w13, w2, k, 2.446)
    assert torch.equal(r.experts, r_loop.experts)
    assert rel(got, want) < 1e-6
    flat = r.experts.reshape(-1)
    order = torch.empty_like(flat).scatter_(0, r.rows.reshape(-1), torch.arange(flat.numel()))  # rows inverted
    assert torch.equal(flat[order], flat.sort(stable=True).values)  # sorted by expert
    assert torch.equal(r.token, order // k)
    assert torch.equal(r.ends.long(), torch.cumsum(torch.bincount(flat, minlength=e), 0))
    assert torch.equal(loads, torch.bincount(flat, minlength=e)) and tally.counts == {"moe.routed_rows": n_tokens * k}


def test_combine_weights_follow_the_published_router():
    """sigmoid scores, the bias for the choice only, normalized, scaled."""
    x = torch.eye(4)
    w = torch.tensor([[3.0, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, 1.0, 0], [0, 0, 0, 0.5]])
    bias = torch.tensor([0.0, 0.0, 0.0, 10.0])  # expert 3 always chosen, at its own score
    r = tmoe.route(x, w, bias, top_k=2, scale=2.0, normalize=True)
    assert (r.experts == 3).any(dim=-1).all()
    row = 0  # token 0: experts 0 (sigmoid 3) and 3 (sigmoid 0)
    s = torch.sigmoid(torch.tensor([3.0, 0.0]))
    got = dict(zip(r.experts[row].tolist(), r.weights[row].tolist()))
    assert got[0] == pytest.approx(float(2 * s[0] / s.sum())) and got[3] == pytest.approx(float(2 * s[1] / s.sum()))


def test_converter_reads_the_hf_key_layout():
    """Every HF tensor lands where the port reads it: a state dict made by
    ``DeepseekV3Model`` itself, under ColPali's prefix, gives the port's
    language model the HF model's hidden states."""
    from transformers import DeepseekV3Model

    cfg = tiny_config()
    hf_cfg = hf_config()
    torch.manual_seed(1)
    hf = DeepseekV3Model(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            p.add_(torch.randn_like(p) * 0.02)  # no norm weight stays at 1
        for layer in hf.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.normal_(0, 0.05)
    sd = {f"{LM_PREFIX}.{k}": v for k, v in hf.state_dict().items()}
    other = draw(cfg)
    sd.update({k: v for k, v in other("misc").items() if not k.startswith(LM_PREFIX)})
    model = colpali_deepseek_from_hf([other("vision"), sd], colpali_cfg(cfg), cfg["image_suffix_ids"],
                                     dtype=torch.float32)
    lm = model.gemma
    assert isinstance(lm, DeepseekLM)
    assert torch.equal(lm.layers[1].mlp["w13"][3, :32], hf.layers[1].mlp.experts[3].gate_proj.weight)
    assert torch.equal(lm.layers[1].mlp["bias"], hf.layers[1].mlp.gate.e_score_correction_bias)
    ids = torch.tensor([[5, 9, 100, 7, 3, 0], [8, 1, 2, 0, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]])
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = lm(lm.embed_tokens(ids), attn_mask=mask)
    valid = mask.bool()
    assert rel(got[valid], want[valid]) < RTOL


def test_converter_refuses_a_model_left_half_filled():
    cfg = tiny_config()
    d = draw(cfg)
    with pytest.raises(ValueError, match="not filled"):
        colpali_deepseek_from_hf([d("vision"), d("misc"), d("layer.0")], colpali_cfg(cfg), cfg["image_suffix_ids"],
                                 dtype=torch.float32)
    with pytest.raises(KeyError):
        colpali_deepseek_from_hf([{"vlm.model.vision_tower.vision_model.extra.weight": torch.zeros(2)}],
                                 colpali_cfg(cfg), cfg["image_suffix_ids"], dtype=torch.float32)


def test_registry_entry_stays_out_of_all():
    info = model_info("ColPali-KimiVL-A3B")
    assert (info.type, info.decoder, info.batch_size) == ("colpali", "deepseek", 8)
    assert "ColPali-KimiVL-A3B" not in [m.name for m in get_models_to_test("all")]
    assert [m.name for m in get_models_to_test("ColPali-KimiVL-A3B")] == ["ColPali-KimiVL-A3B"]


def test_registry_entry_runs_through_the_cli(tmp_path):
    out = tmp_path / "kimi.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "ColPali-KimiVL-A3B",
                    "--sample-size", "8", "--bootstrap-iterations", "4", "--batch-size", "4", "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    assert list(df["Model"]) == ["ColPali-KimiVL-A3B"] and (df["Weights"] == "debug-random").all()
    for col in ("T2I_R@1_mean", "I2T_R@5_mean", "I2T_Sym_R@10_mean"):
        assert all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in df[col]), col
    model = tcli.load_model_for(model_info("ColPali-KimiVL-A3B"), debug=True, arch=False, seed=0, device="cpu")
    assert model.multi_vector and isinstance(model.model.gemma, DeepseekLM)
