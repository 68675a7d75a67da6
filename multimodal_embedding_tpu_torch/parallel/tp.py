"""Tensor parallelism over the mesh's model axis (Megatron-style).

Counterpart of ``multimodal_embedding_tpu/parallel/tp.py``. Attention q, k
and v and the MLP's up projections are column-split (each rank holds a
shard of the heads or of the hidden units), the output projections are
row-split (each rank's partial product is summed over the model axis), and
everything else is replicated.

:func:`tp_specs` is the JAX function's name rule over the port's parameter
names: linear ``{q,k,v,fc1}.{w,b}`` column, ``{o,fc2}.w`` row; Gemma's raw
``q, k, v, gate, up`` column and ``o, down`` row; a dimension that does not
divide the axis stays replicated. Specs are tuples, one axis name or None a
dimension, as the JAX ``PartitionSpec`` of the same leaf less its stacked
layer axis.

:func:`shard_params_tp` keeps each rank's slice of every split weight in
place. XLA can split a head's dimension and insert the collectives; a rank
here runs its attention alone, so a column split must cut whole heads. Where
the heads do not divide the axis, the attention's weights stay whole (the
JAX package's fall-back, logged); where a decoder's KV heads are fewer than
the ranks (Gemma's one), each rank keeps the KV head its query heads read.
Each split decoder layer records the slice it kept (:class:`AttentionSplit`),
which the LoRA adapters (``rl/lora.py``) and the trainer's gradient
reduction (``rl/grpo.py``) read.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from .mesh import Mesh

logger = logging.getLogger("mme_tpu")

MODEL_AXIS = "model"

# linear-module names (models/layers.py): <name>.w [d_in, d_out], <name>.b [d_out]
_COL_PARENTS = frozenset({"q", "k", "v", "fc1"})
_ROW_PARENTS = frozenset({"o", "fc2"})
# raw-weight names (models/gemma.py): <name> [d_in, d_out]
_COL_LEAVES = frozenset({"q", "k", "v", "gate", "up", "fc1"})
_ROW_LEAVES = frozenset({"o", "down", "fc2"})


def tp_specs(params, n_model: int) -> dict[str, tuple]:
    """{parameter name: spec} for Megatron column/row TP at ``n_model``
    shards; ``params`` is a module or a {name: tensor} map."""
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    specs = {}
    for name, leaf in named:
        names = name.split(".")
        leaf_name, parent = names[-1], names[-2] if len(names) >= 2 else ""
        rep: tuple = ()

        def col():
            if leaf.shape[-1] % n_model:
                return rep
            return (*([None] * (leaf.dim() - 1)), MODEL_AXIS)

        def row():
            if leaf.dim() < 2 or leaf.shape[-2] % n_model:
                return rep
            return (*([None] * (leaf.dim() - 2)), MODEL_AXIS, None)

        spec = rep
        if leaf.dim() >= 1:
            if leaf_name in ("w", "b") and parent in _COL_PARENTS:
                spec = col()
            elif leaf_name == "w" and parent in _ROW_PARENTS:
                spec = row()
            elif leaf_name in _COL_LEAVES and leaf.dim() >= 2:
                spec = col()
            elif leaf_name in _ROW_LEAVES and leaf.dim() >= 2:
                spec = row()
        specs[name] = spec
    return specs


@dataclass(frozen=True)
class AttentionSplit:
    """The slice of a decoder layer's attention one rank keeps: ``q`` the
    columns of q (its query heads) and the same rows of o; ``kv`` the
    columns of k and v (the KV heads those query heads read: all of them
    where every rank keeps the one KV head, and shared by several ranks
    where the KV heads are fewer than the ranks)."""

    q: slice
    kv: slice


def _keep(holder, key: str, t: torch.Tensor) -> None:
    """Replace parameter ``key`` of a module or ParameterDict with a copy of
    ``t`` (a slice: a view would keep the whole weight's storage alive)."""
    p = nn.Parameter(t.clone(memory_format=torch.contiguous_format), requires_grad=False)
    if isinstance(holder, nn.ParameterDict):
        holder[key] = p
    else:
        setattr(holder, key, p)


def _cols(t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    return t[..., start:stop]


def _rows(t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    return t[start:stop]


def _shard_attention(m, mesh: Mesh) -> bool:
    """A ``layers.MultiHeadAttention``: this rank's heads of q, k, v and o;
    False (weights kept whole) where the heads do not divide the axis."""
    n, r = mesh.n_model, mesh.model_rank
    if m.n_heads % n:
        return False
    d = m.q.w.shape[1]
    s, e = r * d // n, (r + 1) * d // n
    for lin in (m.q, m.k, m.v):
        _keep(lin, "w", _cols(lin.w, s, e))
        _keep(lin, "b", _cols(lin.b, s, e))
    _keep(m.o, "w", _rows(m.o.w, s, e))
    m.o.reduce_group = mesh.model_group
    m.n_heads //= n
    return True


def _shard_mlp(m, mesh: Mesh, up: tuple[str, ...], down: str) -> bool:
    """Column-split the ``up`` projections, row-split ``down`` (linear
    modules, or a decoder's raw weights in a ParameterDict); False (kept
    whole) where the hidden width does not divide the axis."""
    n, r = mesh.n_model, mesh.model_rank
    raw = isinstance(m, nn.ParameterDict)
    hidden = (m[up[0]] if raw else getattr(m, up[0]).w).shape[-1]
    if hidden % n:
        return False
    s, e = r * hidden // n, (r + 1) * hidden // n
    if raw:
        for name in up:
            _keep(m, name, _cols(m[name], s, e))
        _keep(m, down, _rows(m[down], s, e))
        return True
    for name in up:
        lin = getattr(m, name)
        _keep(lin, "w", _cols(lin.w, s, e))
        _keep(lin, "b", _cols(lin.b, s, e))
    lin = getattr(m, down)
    _keep(lin, "w", _rows(lin.w, s, e))
    lin.reduce_group = mesh.model_group
    return True


def _shard_decoder_layer(layer, mesh: Mesh) -> bool:
    """A ``models/decoder.py:DecoderLayer`` (Gemma, Qwen3): this rank's query
    heads of q and o, the KV heads they read of k and v, and its MLP
    columns, recorded in ``layer.attn_split``. Returns False where the
    attention stays whole (``attn_split`` None)."""
    n, r = mesh.n_model, mesh.model_rank
    cfg, p = layer.cfg, layer.attn
    heads, kvh, dh = cfg.heads, cfg.kv_heads, cfg.head_dim
    attn_split = heads % n == 0 and (kvh % n == 0 or n % kvh == 0)
    if attn_split:
        hl = heads // n
        q0, q1 = r * hl * dh, (r + 1) * hl * dh
        if kvh % n == 0:
            k0, k1 = r * (kvh // n) * dh, (r + 1) * (kvh // n) * dh
        else:  # fewer KV heads than ranks: the one this rank's query heads read
            kv_head = r * hl // (heads // kvh)
            k0, k1 = kv_head * dh, (kv_head + 1) * dh
        _keep(p, "q", _cols(p["q"], q0, q1))
        _keep(p, "k", _cols(p["k"], k0, k1))
        _keep(p, "v", _cols(p["v"], k0, k1))
        _keep(p, "o", _rows(p["o"], q0, q1))
        layer.attn_group = mesh.model_group
        layer.attn_split = AttentionSplit(q=slice(q0, q1), kv=slice(k0, k1))
    if _shard_mlp(layer.mlp, mesh, ("gate", "up"), "down"):
        layer.mlp_group = mesh.model_group
    return attn_split


def shard_params_tp(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's slice of every split weight of ``module``, in place,
    and mark the modules that sum a row-split product over the model axis.
    Returns ``module``, with ``tp_mesh`` set to ``mesh`` on it and on each
    module it split (a no-op on a model axis of 1, and for a module split
    already, as a whole or one layer at a time). Every attention whose heads
    do not divide the axis is logged; modules of no known kind (Jina's
    blocks) stay whole."""
    from ..models.decoder import DecoderLayer
    from ..models.layers import MLP, MultiHeadAttention

    if mesh.n_model == 1 or getattr(module, "tp_mesh", None) is not None:
        return module
    whole = []
    for name, m in module.named_modules():
        if getattr(m, "tp_mesh", None) is not None:
            continue
        if isinstance(m, (MultiHeadAttention, MLP, DecoderLayer)):
            m.tp_mesh = mesh
        if isinstance(m, MultiHeadAttention):
            if not _shard_attention(m, mesh):
                whole.append(f"{name} ({m.n_heads} heads)")
        elif isinstance(m, MLP):
            _shard_mlp(m, mesh, ("fc1",), "fc2")
        elif isinstance(m, DecoderLayer):
            if not _shard_decoder_layer(m, mesh):
                whole.append(f"{name} ({m.cfg.heads} heads over {m.cfg.kv_heads} kv heads)")
    if whole:
        logger.warning(f"tensor parallel {mesh.n_model}: attention kept whole where the heads do not divide the "
                       f"model axis (every rank runs those layers whole): {', '.join(whole)}")
    module.tp_mesh = mesh
    return module
