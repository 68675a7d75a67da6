"""The CLIP and SigLIP towers as the HF equations define them, in plain
PyTorch, on an HF-layout state dict.

CLIP (``CLIPVisionTransformer``, ``CLIPTextTransformer``): patches by a
stride-p convolution without bias, a class token, learned positions, a
LayerNorm before the encoder, pre-LN encoder layers, the class token through
the post LayerNorm and the visual projection; the text tower causal with a
key mask, pooled at the largest id (configs whose ``eos_token_id`` is 2,
HF's legacy rule) or at the first EOS, through the final LayerNorm and the
text projection. SigLIP (``SiglipVisionTransformer``, ``SiglipTextTransformer``):
patches with a bias, no class token, the post LayerNorm over every token,
then the MAP head (a learned probe attending to the tokens through
``nn.MultiheadAttention``, a LayerNorm and an MLP residual); the text tower
bidirectional with a key mask, pooled at the last position through ``head``.

Every product goes through ``numerics.matmul`` in the precision given;
LayerNorms, softmax and activations are float32. Embeddings are returned
unnormalized, float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import matmul, precision
from .preprocess import preprocess
from .tokenizer import tokenize

ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x),
}


def _linear(x, sd, prefix, prec, bias=True):
    y = matmul(x, sd[f"{prefix}.weight"].float().T, prec)
    return y + sd[f"{prefix}.bias"].float() if bias else y


def _ln(x, sd, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{prefix}.weight"].float(), sd[f"{prefix}.bias"].float(), eps)


def attention(q, k, v, heads: int, prec: str, *, causal: bool = False, key_mask=None):
    """Multi-head scaled dot-product attention: q [B, Tq, D], k and v
    [B, Tk, D], key_mask [B, Tk] (nonzero: attend) -> [B, Tq, D]."""
    b, tq, d = q.shape
    tk, dh = k.shape[1], d // heads
    q = q.view(b, tq, heads, dh).transpose(1, 2)
    k = k.view(b, tk, heads, dh).transpose(1, 2)
    v = v.view(b, tk, heads, dh).transpose(1, 2)
    logits = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(dh)
    if causal:
        logits = logits.masked_fill(~torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(), -math.inf)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], -math.inf)
    out = matmul(torch.softmax(logits, dim=-1), v, prec)
    return out.transpose(1, 2).reshape(b, tq, d)


def _encoder(x, sd, prefix, c, prec, *, causal=False, key_mask=None):
    eps, act = c["layer_norm_eps"], ACTIVATIONS[c["hidden_act"]]
    for i in range(c["num_hidden_layers"]):
        p = f"{prefix}.encoder.layers.{i}"
        h = _ln(x, sd, f"{p}.layer_norm1", eps)
        q, k, v = (_linear(h, sd, f"{p}.self_attn.{n}_proj", prec) for n in ("q", "k", "v"))
        a = attention(q, k, v, c["num_attention_heads"], prec, causal=causal, key_mask=key_mask)
        x = x + _linear(a, sd, f"{p}.self_attn.out_proj", prec)
        h = _ln(x, sd, f"{p}.layer_norm2", eps)
        x = x + _linear(act(_linear(h, sd, f"{p}.mlp.fc1", prec)), sd, f"{p}.mlp.fc2", prec)
    return x


def _patches(px, w, prec):
    """A stride-p convolution: px [B, 3, S, S], w [D, 3, p, p] -> [B, N, D]."""
    b, c, s, _ = px.shape
    d, _, p, _ = w.shape
    g = s // p
    x = px[:, :, : g * p, : g * p].reshape(b, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * p * p)
    return matmul(x, w.float().reshape(d, c * p * p).T, prec)


def image_embeddings(images: list[torch.Tensor], sd: dict, cfg: dict, prec: str) -> torch.Tensor:
    """uint8 [3, H, W] images of any geometries -> unnormalized [B, E]."""
    vc = cfg["vision_config"]
    eps, heads = vc["layer_norm_eps"], vc["num_attention_heads"]
    with precision("f32"):
        px = torch.cat([preprocess(im[None], cfg["preprocess"]) for im in images])
    with precision(prec):
        emb = "vision_model.embeddings"
        x = _patches(px, sd[f"{emb}.patch_embedding.weight"], prec)
        if cfg["family"] == "clip":
            cls = sd[f"{emb}.class_embedding"].float().expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1) + sd[f"{emb}.position_embedding.weight"].float()
            x = _ln(x, sd, "vision_model.pre_layrnorm", eps)
            x = _encoder(x, sd, "vision_model", vc, prec)
            pooled = _ln(x[:, 0], sd, "vision_model.post_layernorm", eps)
            return matmul(pooled, sd["visual_projection.weight"].float().T, prec)
        x = x + sd[f"{emb}.patch_embedding.bias"].float() + sd[f"{emb}.position_embedding.weight"].float()
        x = _encoder(x, sd, "vision_model", vc, prec)
        x = _ln(x, sd, "vision_model.post_layernorm", eps)
        head = "vision_model.head"
        d = x.shape[-1]
        w_in, b_in = sd[f"{head}.attention.in_proj_weight"].float(), sd[f"{head}.attention.in_proj_bias"].float()
        probe = sd[f"{head}.probe"].float().expand(x.shape[0], 1, d)
        q = matmul(probe, w_in[:d].T, prec) + b_in[:d]
        k = matmul(x, w_in[d : 2 * d].T, prec) + b_in[d : 2 * d]
        v = matmul(x, w_in[2 * d :].T, prec) + b_in[2 * d :]
        h = _linear(attention(q, k, v, heads, prec), sd, f"{head}.attention.out_proj", prec)
        act = ACTIVATIONS[vc["hidden_act"]]
        h = h + _linear(act(_linear(_ln(h, sd, f"{head}.layernorm", eps), sd, f"{head}.mlp.fc1", prec)), sd,
                        f"{head}.mlp.fc2", prec)
        return h[:, 0]


def text_embeddings(texts: list[str], sd: dict, cfg: dict, prec: str, device) -> torch.Tensor:
    """Captions -> unnormalized [len(texts), E]."""
    tc = cfg["text_config"]
    t = tc["max_position_embeddings"]
    ids, mask = tokenize(texts, tc["vocab_size"], t)
    ids, mask = ids.to(device), mask.to(device)
    with precision(prec):
        x = sd["text_model.embeddings.token_embedding.weight"].float()[ids]
        x = x + sd["text_model.embeddings.position_embedding.weight"].float()[:t]
        clip = cfg["family"] == "clip"
        x = _encoder(x, sd, "text_model", tc, prec, causal=clip, key_mask=mask)
        x = _ln(x, sd, "text_model.final_layer_norm", tc["layer_norm_eps"])
        if not clip:
            return _linear(x[:, -1], sd, "text_model.head", prec)
        if tc["eos_token_id"] == 2:
            pos = ids.argmax(dim=-1)
        else:
            pos = (ids == tc["eos_token_id"]).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=device), pos]
        return matmul(pooled, sd["text_projection.weight"].float().T, prec)
