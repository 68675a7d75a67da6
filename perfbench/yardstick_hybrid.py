"""The work a ``colpali-granite`` round needs, counted from shapes as
``yardstick.py`` counts: valid tokens only, each required operation once,
each kernel's input and output bytes once. The vision side, the page length
and MaxSim are ``yardstick_moe.py``'s.

The language model's products a token: in each Mamba-2 layer ``in_proj``,
the depthwise conv, the scan and ``out_proj``; in each attention layer q, k,
v and o; in every layer the router, ``num_experts_per_tok`` routed experts
and the shared expert; then the 128-d head. Attention is causal over the
valid tokens, GQA: q and o at every head, k and v at the KV heads.

The scan is counted as the recurrence it computes (``ops/ssm.py``), not as
any kernel's form of it, so that the recurrent kernel of today and a chunked
(SSD) one later are judged on the same work: a (token, head) is P * N
elements of the state, each decayed (one multiply), given its input (a
multiply of dt * x_p by B_n, itself one multiply a row, and an add) and read
against C (a multiply and an add), and the D skip (a multiply and an add a
row): 5 P N + 3 P operations. Its bytes are x, dt, B and C read once and y
written once, in bf16. The operations are put against the card's bf16 peak
(``yardstick.bound_s``), the rate of the tensor cores that the chunked form
runs them on, so the bound at these shapes is the bytes.
"""

from __future__ import annotations

from .yardstick import BF16, attention_pairs_causal_masked


def _mamba(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state) of a Mamba-2 layer."""
    return (cfg["mamba_expand"] * cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_head"],
            cfg["mamba_d_state"])


def expert_flops(cfg: dict) -> float:
    """One routed row through one expert: gate, up and down."""
    return 2.0 * 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def scan_flops(cfg: dict) -> float:
    """One token through one Mamba-2 layer's scan, every head."""
    _, heads, p, n = _mamba(cfg)
    return heads * (5.0 * p * n + 3.0 * p)


def token_flops(cfg: dict) -> float:
    """One token's products through the language model and the head."""
    d = cfg["hidden_size"]
    inner, heads, _, state = _mamba(cfg)
    conv = inner + 2 * cfg["mamba_n_groups"] * state
    mamba = 2.0 * d * (inner + conv + heads) + 2.0 * conv * cfg["mamba_d_conv"] + scan_flops(cfg) + 2.0 * inner * d
    hd = d // cfg["num_attention_heads"]
    attn = 2.0 * d * hd * (2 * cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"])
    moe = (2.0 * d * cfg["num_local_experts"] + cfg["num_experts_per_tok"] * expert_flops(cfg)
           + 2.0 * 3 * d * cfg["shared_intermediate_size"])
    n_mamba = cfg["layer_types"].count("mamba")
    flops = n_mamba * mamba + (cfg["num_hidden_layers"] - n_mamba) * attn + cfg["num_hidden_layers"] * moe
    return flops + 2.0 * d * cfg["embedding_dim"]


def attention_work(cfg: dict, valid: list[int]) -> tuple[float, float]:
    """(operations, bytes) of the attention layers over sequences of
    ``valid`` tokens: the causal pairs, QK^T and PV at every query head; q
    and o read and written at every head, k and v at the KV heads."""
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // h
    layers = cfg["layer_types"].count("attention")
    pairs = sum(attention_pairs_causal_masked(n, n) for n in valid)
    return layers * 4.0 * pairs * h * hd, layers * sum(valid) * (2 * h + 2 * kv) * hd * BF16


def expert_work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(operations, bytes) the routed experts of one layer need for a batch
    of ``tokens`` tokens: each routed row through its expert, every expert's
    weights read once (a page batch gives each of the 72 experts about 1144
    rows), the rows read in and written out once."""
    d, width, e = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_local_experts"]
    rows = tokens * cfg["num_experts_per_tok"]
    return rows * expert_flops(cfg), (e * 3.0 * d * width + 2.0 * rows * d) * BF16


def ssm_work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(operations, bytes) of one Mamba-2 layer's scan over a batch of
    ``tokens`` tokens: the recurrence's operations; x, dt, B and C read once
    and y written once."""
    inner, heads, _, state = _mamba(cfg)
    return tokens * scan_flops(cfg), tokens * (2 * inner + heads + 2 * state) * BF16
