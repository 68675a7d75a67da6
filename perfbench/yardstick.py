"""The yardstick: the card's peaks, and the operations and bytes that a
piece of work needs, counted from shapes alone.

Every count is of the work the request needs, not of what the program
happens to compute: padded images, padded batch rows and key positions that
a mask removes are not counted, and each input and output byte of a kernel
counts once. A roofline share is the least time these counts allow over
the measured device time, so it cannot pass 100% unless a count is too high
or a time leaves out part of the work.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at the full
# 700 W power limit.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12, "bytes": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the card ``device_name`` names, or None for a card the
    table lacks (its shares are then not reported)."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def bound_s(flops: float, nbytes: float, peaks: dict, flops_key: str = "bf16_flops") -> float:
    """The least seconds the card needs: the larger of operations over the
    peak rate and bytes over the memory bandwidth."""
    return max(flops / peaks[flops_key], nbytes / peaks["bytes"])


# --- transformer towers ------------------------------------------------------


def _layer_gemm_flops(tokens: int, dim: int, mlp: int) -> float:
    """q, k, v and o projections and the two MLP products of one encoder
    layer over ``tokens`` positions."""
    return 2.0 * tokens * (4 * dim * dim + 2 * dim * mlp)


def attention_pairs_causal_masked(t: int, n_valid: int) -> int:
    """(query, key) pairs a causal mask and a key mask of ``n_valid`` leading
    valid keys leave over ``t`` query rows: row i attends min(i + 1, n)."""
    n = min(n_valid, t)
    return n * (n + 1) // 2 + (t - n) * n


def attention_flops(pairs: float, dim: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, all heads (H * Dh = dim)."""
    return 4.0 * pairs * dim


def vision_tokens(vc: dict, family: str) -> int:
    n = (vc["image_size"] // vc["patch_size"]) ** 2
    return n + 1 if family == "clip" else n


def image_flops(cfg: dict) -> float:
    """One image through the vision tower at its published widths: patch
    embedding, every layer, the pooling head and the projection."""
    vc, family = cfg["vision_config"], cfg["family"]
    d, mlp, layers = vc["hidden_size"], vc["intermediate_size"], vc["num_hidden_layers"]
    patches = (vc["image_size"] // vc["patch_size"]) ** 2
    t = vision_tokens(vc, family)
    flops = 2.0 * patches * 3 * vc["patch_size"] ** 2 * d
    flops += layers * (_layer_gemm_flops(t, d, mlp) + attention_flops(t * t, d))
    if family == "clip":
        flops += 2.0 * d * cfg["projection_dim"]
    else:  # the MAP head: one probe row over the t tokens, then its MLP
        flops += 2.0 * d * d * 2 + 2.0 * t * d * 2 * d + attention_flops(t, d) + 2.0 * 2 * d * mlp
    return flops


def text_len(cfg: dict) -> int:
    return cfg["text_config"]["max_position_embeddings"]


def caption_tokens(caption: str, t: int) -> int:
    """Valid tokens of a caption under the word tokenizer: BOS, one a word
    (at most t - 2), EOS."""
    return min(len(caption.split()), t - 2) + 2


def caption_attention_pairs(cfg: dict, n_valid: int) -> int:
    """Pairs the masks leave for one caption: causal with a key mask (clip),
    a key mask over every query row (siglip)."""
    t = text_len(cfg)
    if cfg["family"] == "clip":
        return attention_pairs_causal_masked(t, n_valid)
    return t * min(n_valid, t)


def caption_flops(cfg: dict, n_valid: int) -> float:
    """One caption through the text tower at the published length (every
    position's products; attention as the masks leave it) and its head."""
    tc = cfg["text_config"]
    d, mlp, layers = tc["hidden_size"], tc["intermediate_size"], tc["num_hidden_layers"]
    t = text_len(cfg)
    flops = layers * (_layer_gemm_flops(t, d, mlp) + attention_flops(caption_attention_pairs(cfg, n_valid), d))
    out = cfg["projection_dim"] if cfg["family"] == "clip" else d
    return flops + 2.0 * d * out


def embed_dim(cfg: dict) -> int:
    return cfg["projection_dim"] if cfg["family"] == "clip" else cfg["vision_config"]["hidden_size"]


def dense_score_flops(n_queries: int, n_docs: int, dim: int) -> float:
    return 2.0 * n_queries * n_docs * dim


# --- kernels -------------------------------------------------------------------

BF16 = 2


def image_attention_work(cfg: dict, n_images: int) -> list[tuple[float, float]]:
    """(operations, bytes) of the attention launches ``n_images`` images
    need, one entry a group of like launches: the vision tower's
    self-attention (q, k, v read and o written once a layer) and, for
    siglip, the MAP head's one probe row over every token."""
    vc, family = cfg["vision_config"], cfg["family"]
    d, layers = vc["hidden_size"], vc["num_hidden_layers"]
    t = vision_tokens(vc, family)
    groups = [(n_images * layers * attention_flops(t * t, d), n_images * layers * 4.0 * t * d * BF16)]
    if family == "siglip":
        groups.append((n_images * attention_flops(t, d), n_images * (2.0 * t * d + 2.0 * d) * BF16))
    return groups


def text_attention_work(cfg: dict, valid_tokens: list[int]) -> tuple[float, float]:
    """(operations, bytes) of one text sweep's attention launches: the pairs
    the masks leave; q, k, v and o at the published length and the int32 key
    mask read once a layer."""
    tc = cfg["text_config"]
    d, layers = tc["hidden_size"], tc["num_hidden_layers"]
    t = text_len(cfg)
    pairs = sum(caption_attention_pairs(cfg, n) for n in valid_tokens)
    nbytes = len(valid_tokens) * layers * (4.0 * t * d * BF16 + 4.0 * t)
    return layers * attention_flops(pairs, d), nbytes


def preprocess_bytes(geometry: tuple[int, int], crop: int) -> float:
    """One image through resize, crop and normalize: its uint8 pixels read
    once, the f32 crop written once."""
    h, w = geometry
    return 3.0 * h * w + 3.0 * crop * crop * 4


# --- statistics ----------------------------------------------------------------


def bootstrap_iteration_flops(n: int, k: int) -> float:
    """The products one bootstrap iteration needs: per own caption t, the
    caption multiplicities [K*N] against "caption c outranks t" [K*N, N]
    (K products), and the T2I and symmetric I2T multiplicities against their
    [N, N] comparison matrices (two)."""
    return 2.0 * k * (k * n) * n + 2.0 * 2 * n * n
