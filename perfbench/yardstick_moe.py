"""The work a ``colpali-deepseek`` round needs, counted from shapes as
``yardstick.py`` counts: valid tokens only (a caption's padding positions
are not counted, though the batch runs them), each required operation once,
each kernel's input and output bytes once.

A page is the headless SigLIP tower over the image's patches, the projector,
then the language model and the head over the patches and the prompt
suffix; a query is the language model and the head over its valid tokens.
The language model's products a token: MLA's q, kv_a, kv_b and o
projections in every layer, the dense SwiGLU in the first layers, the
router, ``top_k`` routed experts and the shared experts in the rest; its
attention causal over the valid tokens, q and k at ``qk_nope + qk_rope`` and
v at ``v_dim`` a head. MaxSim: every valid query token against every page
token.
"""

from __future__ import annotations

from .yardstick import BF16, _layer_gemm_flops, attention_flops, attention_pairs_causal_masked


def page_tokens(cfg: dict) -> int:
    vc = cfg["vision_config"]
    return (vc["image_size"] // vc["patch_size"]) ** 2 + len(cfg["image_suffix_ids"])


def vision_flops(cfg: dict) -> float:
    """One page through the headless tower and the projector."""
    vc = cfg["vision_config"]
    d, p = vc["hidden_size"], vc["patch_size"]
    n = (vc["image_size"] // p) ** 2
    flops = 2.0 * n * 3 * p * p * d
    flops += vc["num_hidden_layers"] * (_layer_gemm_flops(n, d, vc["intermediate_size"]) + attention_flops(n * n, d))
    return flops + 2.0 * n * d * cfg["hidden_size"]


def expert_flops(cfg: dict) -> float:
    """One routed row through one expert: gate, up and down."""
    return 2.0 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def token_flops(cfg: dict) -> float:
    """One token's products through the language model and the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    mla = 2.0 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + vd) + h * vd * d)
    dense = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense
    shared = 2.0 * 3 * d * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    router = 2.0 * d * cfg["n_routed_experts"]
    flops = cfg["num_hidden_layers"] * mla + dense * 2.0 * 3 * d * cfg["intermediate_size"]
    flops += moe_layers * (router + shared + cfg["num_experts_per_tok"] * expert_flops(cfg))
    return flops + 2.0 * d * cfg["embedding_dim"]


def attention_work(cfg: dict, valid: list[int]) -> tuple[float, float]:
    """(operations, bytes) of the language model's attention over sequences
    of ``valid`` tokens, every layer: the causal pairs, QK^T at
    ``qk_nope + qk_rope`` and PV at ``v_dim`` a head; q and k read at
    ``qk_nope + qk_rope``, v read and o written at ``v_dim``."""
    h, qk, vd = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    layers = cfg["num_hidden_layers"]
    pairs = sum(attention_pairs_causal_masked(n, n) for n in valid)
    flops = layers * 2.0 * pairs * h * (qk + vd)
    nbytes = layers * sum(valid) * h * (2 * qk + 2 * vd) * BF16
    return flops, nbytes


def vision_attention_work(cfg: dict, pages: int) -> tuple[float, float]:
    """(operations, bytes) of the vision tower's self-attention over ``pages``."""
    vc = cfg["vision_config"]
    n, d = (vc["image_size"] // vc["patch_size"]) ** 2, vc["hidden_size"]
    launches = pages * vc["num_hidden_layers"]
    return launches * attention_flops(n * n, d), launches * 4.0 * n * d * BF16


def maxsim_flops(cfg: dict, query_valid: list[int], pages: int) -> float:
    """MaxSim of queries of ``query_valid`` tokens against ``pages`` pages."""
    return 2.0 * sum(query_valid) * pages * page_tokens(cfg) * cfg["embedding_dim"]


def expert_work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(operations, bytes) the routed experts of one MoE layer need for a
    batch of ``tokens`` tokens: each of the ``tokens * top_k`` routed rows
    through its expert, every expert's weights read once (at these batch
    sizes every expert gets rows: 8 pages give each about 772 on average), the
    rows read in and written out once."""
    d, width, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    rows = tokens * cfg["num_experts_per_tok"]
    return rows * expert_flops(cfg), (e * 3.0 * d * width + 2.0 * rows * d) * BF16
