"""Transformer building blocks: plain functions on tensors and the small
``nn.Module``s that hold their weights.

Counterpart of ``multimodal_embedding_tpu/models/layers.py``. Weights keep
the JAX layouts (a linear weight is ``[d_in, d_out]``, the encoder's layers
are a list of modules in place of the ``[L, ...]``-stacked tree), so
``models/params.py`` copies a JAX param tree in without transposes.

Numerics follow the JAX package: layer-norm statistics and activations in
f32, softmax in f32, linear layers accumulated in f32. In bf16 a linear's
bias is added to the f32 accumulator where cuBLAS fuses it into the product
(as the JAX package does); otherwise the product is rounded to bf16 before
the add, a difference of at most one bf16 rounding.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# --- ops --------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype, one ``addmm`` (f32 accumulation)."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (population variance), scale and shift
    applied in f32, one rounding to x's dtype (``F.layer_norm`` computes in
    f32 for bf16 inputs)."""
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "quick_gelu": quick_gelu,
    "gelu_pytorch_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}


# Tower self-attention implementation:
#  - "pallas":   the fused attention kernel (ops/attention_cuda.py); the name
#                of the TPU package's kernel route, kept so its command lines
#                run unchanged. On CPU tensors the kernel's plain version.
#  - "flash":    the TPU package's route to jax's library flash-attention
#                kernel (JAX models/layers.py:_flash_sdpa): self-attention
#                with no key mask (causal or not) goes to the same fused
#                kernel, over the real T tokens (the TPU kernel's padding of T
#                to 128 is a lane rule); every other call (a key mask, cross
#                attention) takes the "xla" path, as in the JAX package.
#  - "xla":      einsum SDPA with f32 logits and -inf masking;
#  - "xla_bf16": the same with logits computed in the model dtype;
#  - "auto":     "pallas" for CUDA tensors, "xla" on the CPU. No TPU
#                crossovers carry over: on the card every tower
#                self-attention goes to the kernel.
ATTENTION_IMPLS = ("auto", "xla", "xla_bf16", "pallas", "flash")
_ATTENTION_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    global _ATTENTION_IMPL
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTENTION_IMPLS}, not {impl!r}")
    _ATTENTION_IMPL = impl


def get_attention_impl(device) -> str:
    """Resolved implementation for tensors on ``device`` (never "auto")."""
    if _ATTENTION_IMPL == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return _ATTENTION_IMPL


def attention_impl_for(x: torch.Tensor) -> str:
    """Resolved implementation for activations ``x`` (never "auto")."""
    return get_attention_impl(x.device)


# Encoder-layer implementation:
#  - "xla":   each EncoderLayer as separate PyTorch ops;
#  - "fused": the residual+LN+matmul prologue kernel
#             (ops/fused_ln_matmul_cuda.py) feeding the stacked-QKV attention
#             kernel (ops/attention_cuda.py:fused_attention_qkv); on CPU
#             tensors their plain versions;
#  - "auto":  "xla", as in the JAX package. The JAX package's reason is a TPU
#             measurement and does not carry over; no H100 measurement has
#             chosen between the two yet (PERF.md).
LAYER_IMPLS = ("auto", "xla", "fused")
_LAYER_IMPL = "auto"


def set_layer_impl(impl: str) -> None:
    global _LAYER_IMPL
    if impl not in LAYER_IMPLS:
        raise ValueError(f"layer impl must be one of {LAYER_IMPLS}, not {impl!r}")
    _LAYER_IMPL = impl


def get_layer_impl() -> str:
    """Resolved implementation name (never "auto")."""
    return "xla" if _LAYER_IMPL == "auto" else _LAYER_IMPL


def attention_core(
    qf: torch.Tensor,
    kf: torch.Tensor,
    vf: torch.Tensor,
    n_heads: int,
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,
    self_attn: bool = True,
) -> torch.Tensor:
    """Scaled-dot-product attention over projected activations.

    qf [B, Tq, D]; kf/vf [B, Tk, D]; mask [B, Tk] (nonzero = attend);
    ``self_attn`` False for cross attention (only "flash" reads it).
    Returns [B, Tq, D] in qf's dtype (before the output projection)."""
    b, tq, d = qf.shape
    tk = kf.shape[1]
    dh = d // n_heads
    impl = attention_impl_for(qf)
    if impl == "flash":
        impl = "pallas" if self_attn and mask is None else "xla"

    if impl == "pallas":
        # packed layout: the kernel reads the [B, T, H*Dh] projection output
        # in place, no transposes
        from ..ops.attention_cuda import fused_attention

        out = fused_attention(
            qf, kf, vf, key_mask=mask, causal=causal, layout="packed", num_heads=n_heads
        )
        return out.to(qf.dtype)

    q = qf.reshape(b, tq, n_heads, dh)
    k = kf.reshape(b, tk, n_heads, dh)
    v = vf.reshape(b, tk, n_heads, dh)
    if impl == "xla_bf16":
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)).float()
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if causal:
        cm = torch.ones(tq, tk, dtype=torch.bool, device=qf.device).tril()
        logits = logits.masked_fill(~cm[None, None], -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], -math.inf)
    attn = torch.softmax(logits, dim=-1).to(qf.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
    return out.to(qf.dtype).reshape(b, tq, d)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2 normalize in f32 (torch ``x / x.norm(dim=-1, keepdim=True)``,
    reference main.py:414), returned in x's dtype."""
    xf = x.float()
    return (xf / (torch.linalg.vector_norm(xf, dim=dim, keepdim=True) + eps)).to(x.dtype)


# --- modules ----------------------------------------------------------------


def _uniform(shape, bound: float, gen: torch.Generator, device, dtype) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound).to(dtype)


class Linear(nn.Module):
    """Weight ``w`` [d_in, d_out] (the JAX layout) and bias ``b`` [d_out]."""

    def __init__(self, d_in: int, d_out: int, *, gen: torch.Generator, device, dtype):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(_uniform((d_in, d_out), bound, gen, device, dtype), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """q/k/v/o projections around :func:`attention_core`; with ``kv`` given,
    cross attention (q from ``x``, k and v from ``kv``), as the siglip MAP
    head runs it."""

    def __init__(self, dim: int, n_heads: int, *, gen, device, dtype):
        super().__init__()
        self.n_heads = n_heads
        self.q, self.k, self.v, self.o = (
            Linear(dim, dim, gen=gen, device=device, dtype=dtype) for _ in range(4)
        )

    def forward(self, x, *, kv: torch.Tensor | None = None, causal: bool = False,
                mask: torch.Tensor | None = None):
        self_attn = kv is None
        kv = x if kv is None else kv
        out = attention_core(self.q(x), self.k(kv), self.v(kv), self.n_heads, causal=causal, mask=mask,
                             self_attn=self_attn)
        return self.o(out)


class MLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act: str, *, gen, device, dtype):
        super().__init__()
        self.act = act
        self.fc1 = Linear(dim, mlp_dim, gen=gen, device=device, dtype=dtype)
        self.fc2 = Linear(mlp_dim, dim, gen=gen, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = ACTIVATIONS[self.act](h.float()).to(x.dtype)
        return self.fc2(h)


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer (CLIP structure)."""

    def __init__(self, dim: int, n_heads: int, mlp_dim: int, act: str, ln_eps: float, *, gen, device, dtype):
        super().__init__()
        self.ln1 = LayerNorm(dim, ln_eps, device=device, dtype=dtype)
        self.attn = MultiHeadAttention(dim, n_heads, gen=gen, device=device, dtype=dtype)
        self.ln2 = LayerNorm(dim, ln_eps, device=device, dtype=dtype)
        self.mlp = MLP(dim, mlp_dim, act, gen=gen, device=device, dtype=dtype)

    def forward(self, x, *, causal: bool = False, mask: torch.Tensor | None = None):
        x = x + self.attn(self.ln1(x), causal=causal, mask=mask)
        return x + self.mlp(self.ln2(x))


class Encoder(nn.Module):
    """A stack of :class:`EncoderLayer` (the JAX package scans one layer body
    over ``[L, ...]``-stacked params; here a loop over the layers)."""

    def __init__(self, n_layers: int, dim: int, n_heads: int, mlp_dim: int, act: str,
                 ln_eps: float, *, gen, device, dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_heads, mlp_dim, act, ln_eps, gen=gen, device=device, dtype=dtype)
            for _ in range(n_layers)
        )

    def forward(self, x, *, causal: bool = False, mask: torch.Tensor | None = None):
        if get_layer_impl() == "fused":
            return self._fused_forward(x, causal=causal, mask=mask)
        for layer in self.layers:
            x = layer(x, causal=causal, mask=mask)
        return x

    def _fused_forward(self, x, *, causal: bool, mask: torch.Tensor | None):
        """The pre-LN stack on the fused prologue kernel (the JAX package's
        ``_fused_encoder_stack``). Each layer runs as: one prologue giving
        (residual stream, stacked QKV), attention reading q, k and v straight
        out of the stacked projection, the output projection, a second
        prologue giving (residual stream, activated MLP hidden), and fc2. The
        loop carries ``(h, delta)``, the residual stream and the sublayer
        output not yet added, so every residual add happens inside a kernel
        that reads both; one add follows the last layer. The first layer's
        delta is None (JAX adds zeros: the same values)."""
        from ..ops.attention_cuda import fused_attention_qkv
        from ..ops.fused_ln_matmul_cuda import fused_res_norm_matmul

        d = x.shape[-1]
        use_qkv_kernel = attention_impl_for(x) == "pallas"
        h, delta = x, None
        for layer in self.layers:
            attn = layer.attn
            w_qkv = torch.cat([attn.q.w, attn.k.w, attn.v.w], dim=1)
            b_qkv = torch.cat([attn.q.b, attn.k.b, attn.v.b])
            h, qkv = fused_res_norm_matmul(h, delta, layer.ln1.scale, layer.ln1.bias, w_qkv, b_qkv,
                                           norm="ln", eps=layer.ln1.eps)
            if use_qkv_kernel:
                a = fused_attention_qkv(qkv, mask, causal=causal, num_heads=attn.n_heads).to(h.dtype)
            else:
                a = attention_core(qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], attn.n_heads,
                                   causal=causal, mask=mask)
            h, mlp_h = fused_res_norm_matmul(h, attn.o(a), layer.ln2.scale, layer.ln2.bias, layer.mlp.fc1.w,
                                             layer.mlp.fc1.b, norm="ln", eps=layer.ln2.eps, act=layer.mlp.act)
            delta = layer.mlp.fc2(mlp_h)
        return h if delta is None else h + delta
