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
import torch.distributed as dist
from torch import nn

from .. import runtime
from ..ops.activation_cuda import mlp_activation

# --- ops --------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype, one ``addmm`` (f32 accumulation)."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] @ w [K, N] accumulated and returned in f32."""
    if x2.is_cuda and x2.dtype != torch.float32:
        return torch.mm(x2, w.to(x2.dtype), out_dtype=torch.float32)
    return x2.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with a derivative, which ``torch.mm(..., out_dtype=)`` lacks.
    The output grad is rounded to x's dtype once; each input's grad is then
    one product in that dtype (f32 accumulation), so no f32 copy of w is
    made. w's grad only when w needs one."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        gx = g @ w.to(x2.dtype).T if ctx.needs_input_grad[0] else None
        gw = (x2.T @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] accumulated and returned in f32 (the JAX
    package's ``jnp.dot(..., preferred_element_type=jnp.float32)``), with no
    f32 copy of w: on the card a bf16 product writes f32 straight from cuBLAS
    (``torch.mm(..., out_dtype=torch.float32)``), through :class:`_MatmulF32`
    where autograd records it."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32 and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _MatmulF32.apply(x2, w)
    else:
        y = _mm_f32(x2, w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (population variance), scale and shift
    applied in f32, one rounding to x's dtype (``F.layer_norm`` computes in
    f32 for bf16 inputs)."""
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), scale, bias, eps)


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
    ``self_attn`` False for cross attention (only "flash" reads it). Under
    tensor parallelism D is this rank's column split and ``n_heads`` its
    heads. Returns [B, Tq, D] in qf's dtype (before the output projection)."""
    b, tq, d = qf.shape
    tk = kf.shape[1]
    dh = d // n_heads
    impl = runtime.attention_impl(qf.device)
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
    """Weight ``w`` [d_in, d_out] (the JAX layout) and bias ``b`` [d_out].

    Row-split under tensor parallelism (``reduce_group`` set by
    ``parallel/tp.py``), ``w`` holds this rank's rows: the partial product
    is summed over the model axis in x's dtype, then the bias is added once."""

    reduce_group = None

    def __init__(self, d_in: int, d_out: int, *, gen: torch.Generator, device, dtype):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(_uniform((d_in, d_out), bound, gen, device, dtype), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduce_group is None:
            return linear(x, self.w, self.b)
        y = torch.matmul(x, self.w)
        dist.all_reduce(y, group=self.reduce_group)
        return y + self.b


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
    head runs it. Under tensor parallelism ``parallel/tp.py`` splits the
    heads (``n_heads`` becomes this rank's), or, where they do not divide the
    model axis, keeps the weights whole: every rank then runs the one-rank
    layer."""

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
        # the activation in f32, rounded once to x's dtype: one kernel launch
        # on the card, under tensor parallelism on this rank's fc1 columns
        return self.fc2(mlp_activation(self.fc1(x), self.act))


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
        if runtime.layer_impl() == "fused":
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

        if runtime.current().tp is not None:
            raise ValueError("--layer-impl fused does not take tensor-parallel weights; use xla")
        d = x.shape[-1]
        use_qkv_kernel = runtime.attention_impl(x.device) == "pallas"
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
