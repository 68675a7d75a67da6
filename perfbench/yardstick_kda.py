"""The work a ``colpali-kimi-linear`` round needs, counted from shapes as
``yardstick.py`` counts: valid tokens only, each required operation once,
each kernel's input and output bytes once. The vision side, the page length
and MaxSim are ``yardstick_moe.py``'s.

The language model's products a token: in each KDA layer the q, k and v
projections, their three depthwise convs, the gates' low-rank pairs (f_a and
f_b, g_a and g_b) and b, the recurrence and ``o_proj``; in each MLA layer q,
kv_a, kv_b and o; the first layer's dense SwiGLU; in every later layer the
router, ``num_experts_per_token`` routed experts and the shared expert; then
the 128-d head. MLA's attention is causal over the valid tokens, q and k at
``qk_nope + qk_rope`` and v at ``v_dim`` a head.

The recurrence is counted as the recurrence it computes (``ops/kda.py``), not
as any kernel's form of it, so that the recurrent kernel of today and a
chunked one are judged on the same work, and the same whatever implements the
layer: a (token, head) is K V elements of the state, each decayed (one
multiply), read against k (a multiply and an add), given its correction (a
multiply and an add) and read against q (a multiply and an add): 7 K V
operations. Its bytes are q, k and v read once and o written once in bf16,
g read once in f32 (one a key channel) and beta once in f32 (one a head):
about 1.5 KB a token and head, so that at the bf16 peak the bytes bound it.
"""

from __future__ import annotations

from . import yardstick_moe
from .yardstick import BF16, attention_pairs_causal_masked

F32 = 4


def _kda(cfg: dict) -> tuple[int, int, int, int]:
    """(heads, head_dim, n = heads x head_dim, conv width) of a KDA layer."""
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["num_heads"] * lin["head_dim"], lin["short_conv_kernel_size"]


def layer_counts(cfg: dict) -> tuple[int, int, int]:
    """(KDA layers, MLA layers, MoE layers) of the configuration's depth."""
    n = cfg["num_hidden_layers"]
    kda = sum(1 for i in cfg["linear_attn_config"]["kda_layers"] if i <= n)
    return kda, n - kda, n - cfg["first_k_dense_replace"]


def expert_flops(cfg: dict) -> float:
    """One routed row through one expert: gate, up and down."""
    return 2.0 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def kda_flops(cfg: dict) -> float:
    """One token through one KDA layer's recurrence, every head: 7 K V."""
    h, hd, _, _ = _kda(cfg)
    return h * 7.0 * hd * hd


def kda_layer_flops(cfg: dict) -> float:
    """One token's products through one KDA layer."""
    d = cfg["hidden_size"]
    h, hd, n, width = _kda(cfg)
    proj = 2.0 * d * (3 * n + 2 * hd + h) + 2.0 * 2 * hd * n + 2.0 * n * d
    return proj + 2.0 * 3 * n * width + kda_flops(cfg)


def mla_flops(cfg: dict) -> float:
    """One token's MLA projections (the attention itself is counted apart)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    return 2.0 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + vd) + h * vd * d)


def token_flops(cfg: dict) -> float:
    """One token's products through the language model and the head."""
    d = cfg["hidden_size"]
    n_kda, n_mla, n_moe = layer_counts(cfg)
    moe = (2.0 * d * cfg["num_experts"] + cfg["num_experts_per_token"] * expert_flops(cfg)
           + 2.0 * 3 * d * cfg["num_shared_experts"] * cfg["moe_intermediate_size"])
    dense = cfg["first_k_dense_replace"] * 2.0 * 3 * d * cfg["intermediate_size"]
    return n_kda * kda_layer_flops(cfg) + n_mla * mla_flops(cfg) + n_moe * moe + dense + 2.0 * d * cfg["embedding_dim"]


def attention_work(cfg: dict, valid: list[int]) -> tuple[float, float]:
    """(operations, bytes) of the MLA layers' attention over sequences of
    ``valid`` tokens: the causal pairs, QK^T at ``qk_nope + qk_rope`` and PV
    at ``v_dim`` a head; q and k read at ``qk_nope + qk_rope``, v read and o
    written at ``v_dim``."""
    h, qk, vd = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    layers = layer_counts(cfg)[1]
    pairs = sum(attention_pairs_causal_masked(n, n) for n in valid)
    return layers * 2.0 * pairs * h * (qk + vd), layers * sum(valid) * h * (2 * qk + 2 * vd) * BF16


def expert_work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(operations, bytes) the routed experts of one MoE layer need for a
    batch of ``tokens`` tokens: each routed row through its expert, every
    expert's weights read once (a page batch gives each of the 256 experts
    about 257 rows), the rows read in and written out once."""
    d, width, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts"]
    rows = tokens * cfg["num_experts_per_token"]
    return rows * expert_flops(cfg), (e * 3.0 * d * width + 2.0 * rows * d) * BF16


def kda_work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(operations, bytes) of one KDA layer's recurrence over a batch of
    ``tokens`` tokens: 7 K V operations a token and head; q, k, v read and o
    written once in bf16, g and beta read once in f32."""
    h, _, n, _ = _kda(cfg)
    return tokens * kda_flops(cfg), tokens * (4 * n * BF16 + n * F32 + h * F32)


page_tokens = yardstick_moe.page_tokens
vision_flops = yardstick_moe.vision_flops
vision_attention_work = yardstick_moe.vision_attention_work
maxsim_flops = yardstick_moe.maxsim_flops
