"""ColPali with Kimi-VL-A3B's language model, as the published equations
define it, in plain PyTorch on HF-layout weights: the reference of the
``colpali-kimi-vl-a3b`` configuration.

- Vision: ColPali-v1.3's SigLIP-So400m/14 at 448 without its head
  (``SiglipVisionTransformer`` up to the post LayerNorm; ``towers.py``'s
  encoder), then the projector, a linear to the language model's width.
  PaliGemma's 1/sqrt(d) on image features is not applied: the language
  model is DeepSeek-V3's, which scales neither its inputs nor its
  embeddings.
- Language model: ``DeepseekV3Model`` (``transformers`` 4.57): RMSNorm
  (``weight * x`` after f32 statistics); MLA without a query LoRA (q split
  into 128 + 64 a head; a 512 latent, RMS-normed and up-projected to each
  head's 128 key and 128 value, the latent's norm at eps 1e-6 as the
  published code builds it; one 64-wide rope key for all heads; the
  interleaved rope at theta 800000; scale 192^-1/2); causal attention with
  a key mask; layer 0 a SwiGLU MLP, every later layer sigmoid routing (f32
  logits, the correction bias for the choice only, top 6 of 64, the chosen
  scores normalized and times 2.446), each routed expert a SwiGLU MLP run
  on the rows routed to it (one masked product an expert, no sort or
  grouping), plus the 2 shared experts; the final RMSNorm.
- Head: a linear to 128 dimensions a token, each token L2-normalized
  (``max(norm, 1e-12)``); query pad tokens zero.
- Scores: MaxSim, the sum over the query's tokens of the largest dot
  product with any of the document's tokens (T2I: a caption's tokens against
  a page's; I2T: a page's against a caption's).

Departures from the published model, each a choice of the configuration
(``configs/colpali-kimi-vl-a3b.json``, ``assumed``): the vision side is
ColPali-v1.3's and not Kimi-VL's MoonViT; the image tokens are followed by
a 6-token prompt suffix of fixed ids; captions are tokenized by the word
tokenizer in ColPali's query prompt (:func:`tokenize_queries`); there is no
LM head.

Routing is a step function of the hidden state: a near-tie that rounding
flips changes that token's output by a whole expert, and through attention
every later token's, so two sound computations drift apart with depth. The
reference therefore takes the experts to run from the outputs it is held
against (``forced``) and reports, a token and MoE layer, its own choice and
how far the forced choice lies from it (the margin): a flip of a near-tie
reads a margin near 0, a wrong router a large one.

Weights come from ``draw(part)``, which returns one part's HF-layout
tensors (``"vision"``, ``"misc"``: projector, embedding, final norm and
head, ``"layer.<i>"``); the reference asks for each part once, runs every
page and query through it, and casts a tensor to f32 only where a product
uses it, so at most one layer's f32 copies are alive. Every product goes
through ``numerics.matmul`` in the precision given; norms, softmax, routing
and activations are f32. It imports neither JAX nor the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import matmul, precision
from .preprocess import preprocess
from .towers import _encoder, _ln, _patches

VISION = "vlm.model.vision_tower.vision_model"
LM = "vlm.model.language_model"
AUGMENTATION = 10


def tokenize_queries(texts: list[str], vocab_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ColPali's query prompt on the word tokenizer, a frozen copy: BOS 1,
    one id a lower-cased word of "query: " + text (``2 + hash(word) %
    (vocab - 3)``), 10 augmentation tokens of id 0 (attended), the newline
    as id vocab - 1; padded to the longest with id 0 and mask 0. (ids,
    mask) int64 on the CPU."""
    rows = [[1] + [2 + hash(w) % (vocab_size - 3) for w in ("query: " + t).lower().split()]
            + [0] * AUGMENTATION + [vocab_size - 1] for t in texts]
    n = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), n, dtype=torch.int64)
    mask = torch.zeros(len(rows), n, dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r)
        mask[i, : len(r)] = 1
    return ids, mask


def _lin(x, w, prec):
    """x @ w^T for an HF linear weight w [out, in]."""
    return matmul(x, w.float().T, prec)


def rms_norm(x, w, eps):
    return w.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_interleaved(x, theta):
    """x [B, H, T, d] at positions 0..T-1: the pairs de-interleaved, then
    rotate-half (``apply_rotary_pos_emb_interleave``)."""
    b, h, t, d = x.shape
    x = x.view(b, h, t, d // 2, 2).transpose(4, 3).reshape(b, h, t, d)
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=x.device).float() / d))
    freqs = torch.arange(t, device=x.device).float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def mla(x, sd, p, c, prec, key_mask):
    """``DeepseekV3Attention`` without a query LoRA, causal with a key mask:
    x [B, T, D] -> [B, T, D]."""
    b, t, _ = x.shape
    h, nope, rope, vd = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    q = _lin(x, sd[f"{p}.q_proj.weight"], prec).view(b, t, h, nope + rope).transpose(1, 2)
    kv_a = _lin(x, sd[f"{p}.kv_a_proj_with_mqa.weight"], prec)
    latent, k_rot = kv_a[..., : c["kv_lora_rank"]], kv_a[..., c["kv_lora_rank"] :]
    latent = rms_norm(latent, sd[f"{p}.kv_a_layernorm.weight"], 1e-6)  # DeepseekV3RMSNorm's default eps
    kv = _lin(latent, sd[f"{p}.kv_b_proj.weight"], prec).view(b, t, h, nope + vd).transpose(1, 2)
    k_pass, v = kv[..., :nope], kv[..., nope:]
    q_rot = rope_interleaved(q[..., nope:], c["rope_theta"])
    k_rot = rope_interleaved(k_rot.view(b, 1, t, rope), c["rope_theta"]).expand(b, h, t, rope)
    q = torch.cat([q[..., :nope], q_rot], dim=-1)
    k = torch.cat([k_pass, k_rot], dim=-1)
    logits = matmul(q, k.transpose(-1, -2), prec) * (nope + rope) ** -0.5
    allowed = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
    if key_mask is not None:
        allowed = allowed & key_mask.bool()[:, None, None, :]
    logits = logits.masked_fill(~allowed, -math.inf)
    out = matmul(torch.softmax(logits, dim=-1), v, prec).transpose(1, 2).reshape(b, t, h * vd)
    return _lin(out, sd[f"{p}.o_proj.weight"], prec)


def swiglu(x, sd, p, prec):
    return _lin(F.silu(_lin(x, sd[f"{p}.gate_proj.weight"], prec)) * _lin(x, sd[f"{p}.up_proj.weight"], prec),
                sd[f"{p}.down_proj.weight"], prec)


def moe(x, sd, p, c, prec, forced=None):
    """``DeepseekV3MoE`` over tokens x [N, D]: ([N, D], the chosen experts
    [N, k] ascending, the margin [N]). Where ``forced`` [N, k] holds expert
    ids (-1: none), the layer runs those experts in place of its own choice,
    each weighted by its own score as the published router weights a
    choice; the margin is how far the weakest forced expert's ``score +
    bias`` lies below the k-th largest (0 where the choice is the layer's
    own)."""
    logits = x @ sd[f"{p}.gate.weight"].float().T  # the router in f32, as HF runs it
    scores = torch.sigmoid(logits)
    choice = scores + sd[f"{p}.gate.e_score_correction_bias"].float()
    top = torch.topk(choice, c["num_experts_per_tok"], dim=-1)
    chosen, margin = top.indices, torch.zeros(x.shape[0], device=x.device)
    if forced is not None:
        use = torch.where(forced >= 0, forced, chosen)
        margin = (top.values[:, -1] - choice.gather(1, use).amin(dim=-1)).clamp_min(0.0)
    else:
        use = chosen
    weights = scores.gather(1, use)
    if c["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        hit = use == e  # [N, k]
        rows = hit.any(dim=-1).nonzero().squeeze(-1)
        if rows.numel():
            w = (weights * hit).sum(dim=-1)[rows, None]
            out.index_add_(0, rows, w * swiglu(x[rows], sd, f"{p}.experts.{e}", prec))
    return out + swiglu(x, sd, f"{p}.shared_experts", prec), chosen.sort(dim=-1).values, margin


def decoder_layer(x, sd, i, c, prec, key_mask, forced=None):
    """One ``DeepseekV3DecoderLayer`` over x [B, T, D]: (x, the layer's own
    chosen experts [B, T, k] and the margin [B, T] of ``forced`` [B, T, k]
    (:func:`moe`), both None in a dense layer)."""
    p = f"{LM}.layers.{i}"
    eps = c["rms_norm_eps"]
    x = x + mla(rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps), sd, f"{p}.self_attn", c, prec, key_mask)
    h = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
    if i < c["first_k_dense_replace"]:
        return x + swiglu(h, sd, f"{p}.mlp", prec), None, None
    b, t, d = h.shape
    out, chosen, margin = moe(h.reshape(-1, d), sd, f"{p}.mlp", c, prec,
                              None if forced is None else forced.reshape(b * t, -1))
    return x + out.view_as(h), chosen.view(b, t, -1), margin.view(b, t)


def vision_features(images: list[torch.Tensor], sd: dict, cfg: dict, prec: str) -> torch.Tensor:
    """uint8 [3, H, W] images -> the headless tower's [B, N, Dv] in f32."""
    vc = cfg["vision_config"]
    with precision("f32"):
        px = torch.cat([preprocess(im[None], cfg["preprocess"]) for im in images])
    with precision(prec):
        emb = f"{VISION}.embeddings"
        x = _patches(px, sd[f"{emb}.patch_embedding.weight"], prec)
        x = x + sd[f"{emb}.patch_embedding.bias"].float() + sd[f"{emb}.position_embedding.weight"].float()
        x = _encoder(x, sd, VISION, vc, prec)
        return _ln(x, sd, f"{VISION}.post_layernorm", vc["layer_norm_eps"])


def embed(images: list[torch.Tensor], texts: list[str], draw, cfg: dict, prec: str, device,
          forced: dict | None = None) -> dict:
    """Pages (uint8 images) and queries (captions) through the whole model:
    {"pages": [P, N + suffix, E], "queries": [Q, T, E] (pad tokens zero),
    "query_mask": [Q, T], "page_routes", "query_routes": each token's own
    chosen experts in each MoE layer, [..., L, k] ascending, "page_margin",
    "query_margin": [..., L]}, embeddings f32 and L2-normalized a token.
    ``forced`` {"pages": [P, N + suffix, L, k], "queries": [Q, T, L, k]}
    (-1: none) gives the experts each MoE layer runs (:func:`moe`)."""
    suffix = torch.as_tensor(cfg["image_suffix_ids"], device=device)
    ids, mask = (x.to(device) for x in tokenize_queries(texts, cfg["vocab_size"]))
    with precision(prec):
        feats = vision_features(images, draw("vision"), cfg, prec)
        misc = draw("misc")
        proj = "vlm.model.multi_modal_projector.linear"
        page = _lin(feats, misc[f"{proj}.weight"], prec) + misc[f"{proj}.bias"].float()
        table = misc[f"{LM}.embed_tokens.weight"]
        page = torch.cat([page, table[suffix].float().expand(page.shape[0], -1, -1)], dim=1)
        query = table[ids].float()
        final = {k: misc[k] for k in (f"{LM}.norm.weight", "embedding_proj_layer.weight", "embedding_proj_layer.bias")}
        del misc, table
        routes = {"pages": [], "queries": []}
        margins = {"pages": [], "queries": []}
        j = 0
        for i in range(cfg["num_hidden_layers"]):
            sd = draw(f"layer.{i}")
            moe_layer = i >= cfg["first_k_dense_replace"]
            f_page, f_query = ((forced[k][:, :, j] if forced is not None and moe_layer else None)
                               for k in ("pages", "queries"))
            page, r_page, m_page = decoder_layer(page, sd, i, cfg, prec, None, f_page)
            query, r_query, m_query = decoder_layer(query, sd, i, cfg, prec, mask, f_query)
            del sd
            if moe_layer:
                j += 1
                for k, r, m in (("pages", r_page, m_page), ("queries", r_query, m_query)):
                    routes[k].append(r)
                    margins[k].append(m)
        out = {}
        for name, x in (("pages", page), ("queries", query)):
            x = rms_norm(x, final[f"{LM}.norm.weight"], cfg["rms_norm_eps"])
            x = _lin(x, final["embedding_proj_layer.weight"], prec) + final["embedding_proj_layer.bias"].float()
            out[name] = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    out["queries"] = out["queries"] * mask[:, :, None].float()
    out["query_mask"] = mask
    for k, name in (("pages", "page"), ("queries", "query")):
        out[f"{name}_routes"] = torch.stack(routes[k], dim=2)
        out[f"{name}_margin"] = torch.stack(margins[k], dim=2)
    return out


def maxsim(queries: torch.Tensor, docs: torch.Tensor, prec: str) -> torch.Tensor:
    """[Q, T, E] x [D, N, E] -> [Q, D]: each query token's best dot product
    over the document's tokens, summed over the query's tokens (a zero pad
    token adds 0 as a query token and a floor of 0 as a document token)."""
    with precision(prec):
        sims = matmul(queries[:, None], docs[None].transpose(-1, -2), prec)  # [Q, D, T, N]
    return sims.amax(dim=-1).sum(dim=-1)
