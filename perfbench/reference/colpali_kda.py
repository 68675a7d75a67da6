"""ColPali with Kimi-Linear-48B-A3B's language model, as the published
equations define it, in plain PyTorch on HF-layout weights: the reference of
the ``colpali-kimi-linear-48b-a3b`` configuration.

- Vision, projector, head and scores: ``colpali_moe.py``'s (ColPali-v1.3's
  SigLIP-So400m/14 at 448 without its head, a linear to the language
  model's width, a 128-d head L2-normalized a token, MaxSim).
- Language model: ``KimiLinearModel`` (``modeling_kimi.py``): RMSNorm
  (``weight * x`` after f32 statistics); each layer ``x + mixer(rmsnorm(x))``
  then ``x + mlp(rmsnorm(x))``; the final RMSNorm; no scale on the inputs.
- The MLA layers (``full_attn_layers``, 1-based): ``colpali_moe.py``'s MLA
  with ``mla_use_nope``, the rope parts of q and of the shared key kept as
  they are, unrotated (written here: ``colpali_moe.mla`` always rotates);
  causal with a key mask; scale 192^-1/2.
- The KDA layers (``kda_layers``): q, k and v projections, each through its
  causal depthwise conv (width ``short_conv_kernel_size``, no bias) and SiLU;
  ``g = -exp(A_log) * softplus(f_b(f_a(x)) + dt_bias)`` a key channel,
  ``beta = sigmoid(b(x))`` a head; the delta rule written token by token,
  each head's state [128, 128] in f32: ``S = exp(g_t) * S`` (a row of S a key
  channel), ``u = beta_t (v_t - S^T k_t)``, ``S = S + k_t u^T``, ``o_t = S^T
  q_t``, with q_t and k_t L2-normalised (eps 1e-6) and q_t scaled by
  128^-1/2; the gated norm ``w * rmsnorm(o) * sigmoid(g_b(g_a(x)))`` over each
  head's channels; ``o_proj``. A key mask zeroes the padded positions of the
  mixer's input, of the convs' outputs and of g, so the state passes a pad
  as it is (the published layer packs the valid tokens instead).
- The MLPs: the first layer a SwiGLU (``mlp.{gate,up,down}_proj``);
  every later one ``colpali_moe.py``'s MoE (sigmoid scores, the correction
  bias for the choice, top ``num_experts_per_token`` of ``num_experts``,
  renormalised and times ``routed_scaling_factor``, each routed expert run
  on the rows routed to it, the shared expert added), its expert ``w1``,
  ``w3`` and ``w2`` read as gate, up and down.

Departures from the published model are those of the configuration
(``configs/colpali-kimi-linear-48b-a3b.json``, ``assumed``): the vision side
is ColPali-v1.3's, the image tokens are followed by a 6-token prompt suffix of
fixed ids, captions are tokenized by the word tokenizer in ColPali's query
prompt, there is no LM head, and the model is its first 16 layers.

Routing is a step function of the hidden state, so, as in ``colpali_moe.py``,
the reference runs the experts of the outputs it is held against
(``forced``) and reports, a token and MoE layer, its own choice and the
margin of the forced choice.

Weights come from ``draw(part)`` (``"vision"``, ``"misc"``, ``"layer.<i>"``),
each part asked for once and each tensor raised to f32 only where it is used,
so on the card at most one layer's weights are held at a time. Every product
goes through ``numerics.matmul`` in the precision given (the recurrence's
three products a token too); norms, softmax, routing, the convs, the decays
and activations are f32. It imports neither JAX nor the port.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from . import colpali_moe
from .colpali_moe import LM, _lin, maxsim, rms_norm, swiglu, tokenize_queries, vision_features
from .numerics import matmul, precision

__all__ = ["embed", "maxsim"]

L2_EPS = 1e-6


def l2norm(x):
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + L2_EPS)


def delta_rule(q, k, v, g, beta, prec):
    """The gated delta rule with a decay a key channel, token by token: q, k,
    v and g [B, T, H, K], beta [B, T, H] -> o [B, T, H, V]; the state [B, H, K,
    V] in f32."""
    b, t, h, kd = q.shape
    q = l2norm(q) * kd**-0.5
    k = l2norm(k)
    state = q.new_zeros(b, h, kd, v.shape[-1])
    out = []
    for i in range(t):
        state = state * torch.exp(g[:, i])[..., None]
        kv = matmul(k[:, i, :, None, :], state, prec)[:, :, 0]  # S^T k: [B, H, V]
        u = beta[:, i, :, None] * (v[:, i] - kv)
        state = state + matmul(k[:, i, :, :, None], u[:, :, None, :], prec)
        out.append(matmul(q[:, i, :, None, :], state, prec)[:, :, 0])
    return torch.stack(out, dim=1)


def kda(x, sd, p, c, prec, key_mask):
    """``KimiDeltaAttention`` without a cache: x [B, T, D] -> [B, T, D]."""
    b, t, _ = x.shape
    lin = c["linear_attn_config"]
    h, hd, width = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    mask = None if key_mask is None else key_mask.float()[:, :, None]
    if mask is not None:
        x = x * mask

    def short_conv(name):
        y = _lin(x, sd[f"{p}.{name}_proj.weight"], prec).transpose(1, 2)
        y = F.conv1d(F.pad(y, (width - 1, 0)), sd[f"{p}.{name}_conv1d.weight"].float(), groups=y.shape[1])
        y = F.silu(y).transpose(1, 2)
        return (y if mask is None else y * mask).reshape(b, t, h, hd)

    q, k, v = short_conv("q"), short_conv("k"), short_conv("v")
    f = _lin(_lin(x, sd[f"{p}.f_a_proj.weight"], prec), sd[f"{p}.f_b_proj.weight"], prec).view(b, t, h, hd)
    g = -torch.exp(sd[f"{p}.A_log"].float())[:, None] * F.softplus(f + sd[f"{p}.dt_bias"].float().view(h, hd))
    if mask is not None:
        g = g * mask[..., None]
    beta = torch.sigmoid(_lin(x, sd[f"{p}.b_proj.weight"], prec))
    o = delta_rule(q, k, v, g, beta, prec)
    gate = _lin(_lin(x, sd[f"{p}.g_a_proj.weight"], prec), sd[f"{p}.g_b_proj.weight"], prec).view(b, t, h, hd)
    o = rms_norm(o, sd[f"{p}.o_norm.weight"], c["rms_norm_eps"]) * torch.sigmoid(gate)
    return _lin(o.reshape(b, t, h * hd), sd[f"{p}.o_proj.weight"], prec)


def mla_nope(x, sd, p, c, prec, key_mask):
    """``colpali_moe.mla`` with ``mla_use_nope``: no rotation of the rope
    parts; causal with a key mask. x [B, T, D] -> [B, T, D]."""
    b, t, _ = x.shape
    h, nope, rope, vd = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    q = _lin(x, sd[f"{p}.q_proj.weight"], prec).view(b, t, h, nope + rope).transpose(1, 2)
    kv_a = _lin(x, sd[f"{p}.kv_a_proj_with_mqa.weight"], prec)
    latent, k_rot = kv_a[..., : c["kv_lora_rank"]], kv_a[..., c["kv_lora_rank"] :]
    latent = rms_norm(latent, sd[f"{p}.kv_a_layernorm.weight"], 1e-6)
    kv = _lin(latent, sd[f"{p}.kv_b_proj.weight"], prec).view(b, t, h, nope + vd).transpose(1, 2)
    k = torch.cat([kv[..., :nope], k_rot.view(b, 1, t, rope).expand(b, h, t, rope)], dim=-1)
    logits = matmul(q, k.transpose(-1, -2), prec) * (nope + rope) ** -0.5
    allowed = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
    if key_mask is not None:
        allowed = allowed & key_mask.bool()[:, None, None, :]
    logits = logits.masked_fill(~allowed, -math.inf)
    out = matmul(torch.softmax(logits, dim=-1), kv[..., nope:], prec).transpose(1, 2).reshape(b, t, h * vd)
    return _lin(out, sd[f"{p}.o_proj.weight"], prec)


_EXPERT = re.compile(r"(experts\.\d+)\.(gate|up|down)_proj")
_W = {"gate": "w1", "down": "w2", "up": "w3"}


class _ExpertNames:
    """``sd`` read under ``colpali_moe.moe``'s expert names: an expert's
    ``gate_proj``, ``up_proj`` and ``down_proj`` are Kimi-Linear's ``w1``,
    ``w3`` and ``w2``."""

    def __init__(self, sd):
        self.sd = sd

    def __getitem__(self, key):
        return self.sd[_EXPERT.sub(lambda m: f"{m[1]}.{_W[m[2]]}", key)]


def moe_config(cfg: dict) -> dict:
    """``cfg`` with the MoE keys ``colpali_moe.moe`` reads."""
    return {**cfg, "n_routed_experts": cfg["num_experts"], "num_experts_per_tok": cfg["num_experts_per_token"],
            "norm_topk_prob": cfg["moe_renormalize"]}


def decoder_layer(x, sd, i, c, prec, key_mask, forced=None):
    """One ``KimiDecoderLayer`` over x [B, T, D] (``c`` through
    :func:`moe_config`): (x, the layer's own chosen experts [B, T, k] and the
    margin [B, T] of ``forced`` [B, T, k], both None in the dense layer)."""
    p = f"{LM}.layers.{i}"
    eps = c["rms_norm_eps"]
    mixer = kda if i + 1 in c["linear_attn_config"]["kda_layers"] else mla_nope
    x = x + mixer(rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps), sd, f"{p}.self_attn", c, prec, key_mask)
    h = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
    if i < c["first_k_dense_replace"]:
        return x + swiglu(h, sd, f"{p}.mlp", prec), None, None
    b, t, d = h.shape
    out, chosen, margin = colpali_moe.moe(h.reshape(-1, d), _ExpertNames(sd), f"{p}.block_sparse_moe", c, prec,
                                          None if forced is None else forced.reshape(b * t, -1))
    return x + out.view_as(h), chosen.view(b, t, -1), margin.view(b, t)


def embed(images: list[torch.Tensor], texts: list[str], draw, cfg: dict, prec: str, device,
          forced: dict | None = None) -> dict:
    """Pages (uint8 images) and queries (captions) through the whole model:
    {"pages": [P, N + suffix, E], "queries": [Q, T, E] (pad tokens zero),
    "query_mask": [Q, T], "page_routes", "query_routes": each token's own
    chosen experts in each MoE layer, [..., L, k] ascending, "page_margin",
    "query_margin": [..., L]}, embeddings f32 and L2-normalized a token.
    ``forced`` {"pages": [P, N + suffix, L, k], "queries": [Q, T, L, k]}
    (-1: none) gives the experts each MoE layer runs."""
    c = moe_config(cfg)
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
            page, r_page, m_page = decoder_layer(page, sd, i, c, prec, None, f_page)
            query, r_query, m_query = decoder_layer(query, sd, i, c, prec, mask, f_query)
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
