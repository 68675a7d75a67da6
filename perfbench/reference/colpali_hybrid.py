"""ColPali with Granite-4.0-H-Small's language model, as the published
equations define it, in plain PyTorch on HF-layout weights: the reference of
the ``colpali-granite-4.0-h-small`` configuration.

- Vision, projector, head and scores: ``colpali_moe.py``'s (ColPali-v1.3's
  SigLIP-So400m/14 at 448 without its head, a linear to the language
  model's width, a 128-d head L2-normalized a token, MaxSim).
- Language model: ``GraniteMoeHybridModel`` (``transformers`` 4.57, its
  ``torch_forward`` for the Mamba-2 layers): the inputs (image features and
  token embeddings alike) times ``embedding_multiplier``; each layer
  ``x + r * mixer(rmsnorm(x))``, then ``x + r * (moe(u) + shared(u))`` with
  ``u = rmsnorm(x)`` and ``r`` the ``residual_multiplier``; the final
  RMSNorm.
- The Mamba-2 mixer: ``in_proj`` to z, xBC and dt; the padded positions of
  its input zeroed; xBC through the causal depthwise conv (width
  ``mamba_d_conv``, with bias), SiLU, the padded positions zeroed again,
  split into x [heads, head_dim], B and C [state]; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the scan written token by token, each
  head's state [head_dim, state] in f32: ``S_t = exp(dt_t A) S_{t-1} +
  (dt_t x_t) B_t^T``, ``y_t = S_t C_t + D x_t``; the gated norm ``w *
  rmsnorm(y * silu(z))`` over all channels; ``out_proj``.
- The attention mixer: q, k, v, o without bias, ``num_attention_heads``
  query and ``num_key_value_heads`` key/value heads of ``hidden_size /
  num_attention_heads``, no rotary embedding, scale
  ``attention_multiplier``, causal with a key mask.
- The MoE: logits ``u @ W^T`` in f32, the top ``num_experts_per_tok`` of
  ``num_local_experts``, their weights the softmax of the chosen logits;
  each expert a SwiGLU (``input_linear``: gate then up; ``output_linear``)
  run on the rows routed to it (one masked product an expert); the shared
  SwiGLU added.

Departures from the published model are those of the configuration
(``configs/colpali-granite-4.0-h-small.json``, ``assumed``): the vision side
is ColPali-v1.3's, the image tokens are followed by a 6-token prompt suffix of
fixed ids, captions are tokenized by the word tokenizer in ColPali's query
prompt, there is no LM head.

Routing is a step function of the hidden state, so, as in ``colpali_moe.py``,
the reference runs the experts of the outputs it is held against
(``forced``) and reports, a token and layer, its own choice and the margin of
the forced choice: how far the weakest forced expert's logit lies below the
k-th largest logit, in raw logits (0 where the choice is its own).

Weights come from ``draw(part)`` (``"vision"``, ``"misc"``, ``"layer.<i>"``),
each part asked for once; every product goes through ``numerics.matmul`` in
the precision given (the scan's two products too: the input's outer product
and the state's product with C); norms, softmax, routing, the conv, the
decays and activations are f32. It imports neither JAX nor the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .colpali_moe import LM, _lin, maxsim, rms_norm, tokenize_queries, vision_features
from .numerics import matmul, precision

__all__ = ["embed", "maxsim"]


def scan(x, dt, a, bm, cm, d, prec):
    """The selective scan token by token: x [B, T, H, P], dt [B, T, H], a and
    d [H], B and C [B, T, N] -> y [B, T, H, P]; the state in f32."""
    b, t, h, p = x.shape
    state = x.new_zeros(b, h, p, bm.shape[-1])
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a)[:, :, None, None]
        u = (dt[:, i, :, None] * x[:, i])[..., None]  # [B, H, P, 1]
        state = decay * state + matmul(u, bm[:, i, None, None, :], prec)
        ys.append(matmul(state, cm[:, i, None, :, None], prec)[..., 0])
    return torch.stack(ys, dim=1) + d[:, None] * x


def mamba(x, sd, p, c, prec, key_mask):
    """``GraniteMoeHybridMambaLayer.torch_forward`` without a cache: x [B, T,
    D] -> [B, T, D]."""
    b, t, d = x.shape
    inner, heads, state = c["mamba_expand"] * d, c["mamba_n_heads"], c["mamba_d_state"]
    mask = None if key_mask is None else key_mask.float()[:, :, None]
    if mask is not None:
        x = x * mask
    z, xbc, dt = _lin(x, sd[f"{p}.in_proj.weight"], prec).split([inner, inner + 2 * state, heads], dim=-1)
    k = c["mamba_d_conv"]
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), sd[f"{p}.conv1d.weight"].float(),
                   sd[f"{p}.conv1d.bias"].float(), groups=xbc.shape[-1])
    xbc = F.silu(xbc).transpose(1, 2)
    if mask is not None:
        xbc = xbc * mask
    xs, bm, cm = xbc.split([inner, state, state], dim=-1)
    dt = F.softplus(dt + sd[f"{p}.dt_bias"].float())
    a = -torch.exp(sd[f"{p}.A_log"].float())
    y = scan(xs.view(b, t, heads, -1), dt, a, bm, cm, sd[f"{p}.D"].float(), prec).reshape(b, t, inner)
    g = y * F.silu(z)
    g = sd[f"{p}.norm.weight"].float() * (g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + c["rms_norm_eps"]))
    return _lin(g, sd[f"{p}.out_proj.weight"], prec)


def attention(x, sd, p, c, prec, key_mask):
    """``GraniteMoeHybridAttention`` without rope, causal with a key mask."""
    b, t, d = x.shape
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // h
    q = _lin(x, sd[f"{p}.q_proj.weight"], prec).view(b, t, h, hd).transpose(1, 2)
    k = _lin(x, sd[f"{p}.k_proj.weight"], prec).view(b, t, kv, hd).transpose(1, 2).repeat_interleave(h // kv, dim=1)
    v = _lin(x, sd[f"{p}.v_proj.weight"], prec).view(b, t, kv, hd).transpose(1, 2).repeat_interleave(h // kv, dim=1)
    logits = matmul(q, k.transpose(-1, -2), prec) * c["attention_multiplier"]
    allowed = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
    if key_mask is not None:
        allowed = allowed & key_mask.bool()[:, None, None, :]
    logits = logits.masked_fill(~allowed, -math.inf)
    out = matmul(torch.softmax(logits, dim=-1), v, prec).transpose(1, 2).reshape(b, t, h * hd)
    return _lin(out, sd[f"{p}.o_proj.weight"], prec)


def swiglu(x, w_in, w_out, prec):
    """An expert of ``input_linear`` w_in [2I, D] (gate, then up) and
    ``output_linear`` w_out [D, I]."""
    gate, up = _lin(x, w_in, prec).chunk(2, dim=-1)
    return _lin(F.silu(gate) * up, w_out, prec)


def moe(x, sd, p, c, prec, forced=None):
    """``GraniteMoeHybridMoE`` plus the shared MLP over tokens x [N, D]: ([N,
    D], the chosen experts [N, k] ascending, the margin [N]). Where
    ``forced`` [N, k] holds expert ids (-1: none), the layer runs those
    experts in place of its own choice, weighted by the softmax of their
    logits as the published router weights a choice; the margin is how far
    the weakest forced expert's logit lies below the k-th largest (0 where
    the choice is the layer's own)."""
    logits = x @ sd[f"{p}.block_sparse_moe.router.layer.weight"].float().T  # the router in f32
    top = torch.topk(logits, c["num_experts_per_tok"], dim=-1)
    chosen, margin = top.indices, torch.zeros(x.shape[0], device=x.device)
    use = chosen
    if forced is not None:
        use = torch.where(forced >= 0, forced, chosen)
        margin = (top.values[:, -1] - logits.gather(1, use).amin(dim=-1)).clamp_min(0.0)
    weights = torch.softmax(logits.gather(1, use), dim=-1)
    w_in, w_out = sd[f"{p}.block_sparse_moe.input_linear.weight"], sd[f"{p}.block_sparse_moe.output_linear.weight"]
    out = torch.zeros_like(x)
    for e in range(c["num_local_experts"]):
        hit = use == e  # [N, k]
        rows = hit.any(dim=-1).nonzero().squeeze(-1)
        if rows.numel():
            w = (weights * hit).sum(dim=-1)[rows, None]
            out.index_add_(0, rows, w * swiglu(x[rows], w_in[e], w_out[e], prec))
    shared = swiglu(x, sd[f"{p}.shared_mlp.input_linear.weight"], sd[f"{p}.shared_mlp.output_linear.weight"], prec)
    return out + shared, chosen.sort(dim=-1).values, margin


def decoder_layer(x, sd, i, c, prec, key_mask, forced=None):
    """One ``GraniteMoeHybridDecoderLayer`` over x [B, T, D]: (x, its own
    chosen experts [B, T, k], the margin [B, T] of ``forced`` [B, T, k])."""
    p = f"{LM}.layers.{i}"
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    h = rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps)
    mixer = mamba if c["layer_types"][i] == "mamba" else attention
    sub = "mamba" if c["layer_types"][i] == "mamba" else "self_attn"
    x = x + r * mixer(h, sd, f"{p}.{sub}", c, prec, key_mask)
    h = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
    b, t, d = h.shape
    out, chosen, margin = moe(h.reshape(-1, d), sd, p, c, prec, None if forced is None else forced.reshape(b * t, -1))
    return x + r * out.view_as(h), chosen.view(b, t, -1), margin.view(b, t)


def embed(images: list[torch.Tensor], texts: list[str], draw, cfg: dict, prec: str, device,
          forced: dict | None = None) -> dict:
    """Pages (uint8 images) and queries (captions) through the whole model:
    {"pages": [P, N + suffix, E], "queries": [Q, T, E] (pad tokens zero),
    "query_mask": [Q, T], "page_routes", "query_routes": each token's own
    chosen experts in each layer, [..., L, k] ascending, "page_margin",
    "query_margin": [..., L]}, embeddings f32 and L2-normalized a token.
    ``forced`` {"pages": [P, N + suffix, L, k], "queries": [Q, T, L, k]}
    (-1: none) gives the experts each layer runs (:func:`moe`)."""
    suffix = torch.as_tensor(cfg["image_suffix_ids"], device=device)
    ids, mask = (x.to(device) for x in tokenize_queries(texts, cfg["vocab_size"]))
    scale = cfg["embedding_multiplier"]
    with precision(prec):
        feats = vision_features(images, draw("vision"), cfg, prec)
        misc = draw("misc")
        proj = "vlm.model.multi_modal_projector.linear"
        page = _lin(feats, misc[f"{proj}.weight"], prec) + misc[f"{proj}.bias"].float()
        table = misc[f"{LM}.embed_tokens.weight"]
        page = torch.cat([page, table[suffix].float().expand(page.shape[0], -1, -1)], dim=1) * scale
        query = table[ids].float() * scale
        final = {k: misc[k] for k in (f"{LM}.norm.weight", "embedding_proj_layer.weight", "embedding_proj_layer.bias")}
        del misc, table
        routes = {"pages": [], "queries": []}
        margins = {"pages": [], "queries": []}
        for i in range(cfg["num_hidden_layers"]):
            sd = draw(f"layer.{i}")
            f_page, f_query = ((forced[k][:, :, i] if forced is not None else None) for k in ("pages", "queries"))
            page, r_page, m_page = decoder_layer(page, sd, i, cfg, prec, None, f_page)
            query, r_query, m_query = decoder_layer(query, sd, i, cfg, prec, mask, f_query)
            del sd
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
