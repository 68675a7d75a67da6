"""ColPali: the PaliGemma-based multi-vector late-interaction retriever.

Counterpart of ``multimodal_embedding_tpu/models/colpali.py``:

- vision: the headless SigLIP tower (``towers.py``, ``use_head=False``) ->
  [B, N, Dv];
- multimodal projector: a linear to the Gemma width, its bias added before
  the cast to the model dtype (HF PaliGemma's 1/sqrt(dim) on image features
  cancels Gemma's sqrt(dim) on the merged embeddings, so image features
  enter the decoder at projector scale; text embeddings carry the scale);
- language model: Gemma (``gemma.py``) over [image features | prompt suffix]
  with PaliGemma's inference mask (every token attends to every valid token),
  or, where the configuration's ``gemma`` is a ``DeepseekConfig``, the
  DeepSeek-V3 decoder of Kimi-VL-A3B (``deepseek.py``) with its own causal
  mask; that model scales neither its token embeddings nor the image
  features, so both enter it as they are; where it is a ``GraniteConfig``,
  Granite-4.0-H's hybrid Mamba-2 and MoE decoder (``granite.py``), causal,
  which scales both alike by its ``embedding_multiplier``; where it is a
  ``KimiLinearConfig``, Kimi-Linear's hybrid KDA and MLA decoder with its
  MoE (``kimi_linear.py``), causal, which scales neither;
- retrieval head: a linear to 128 dims per token in f32, L2-normalized per
  token with ``max(norm, 1e-12)``; query pad tokens are zeroed (HF
  ColPaliForRetrieval's ``emb * mask``, COMPAT #8).

Under ``--sequence-parallel`` (``parallel/sp.py``) the vision tower runs
whole on every rank, as in the JAX package; Gemma and the head run on this
rank's token shard where the model axis divides the sequence, and the
per-token embeddings are gathered at the end.

Scoring runs MaxSim without masks: a zero pad vector adds a 0 floor to the
doc-token max and exactly 0 to the query sum. ``colpali_params_from_hf``
converts an HF ``ColPaliForRetrieval`` state dict into the JAX package's
param tree (numpy), which ``load_colpali`` carries into the module.
:func:`colpali_deepseek_from_hf` loads the DeepSeek variant from HF-layout
tensors part by part on their own device (its 15.6 B parameters would take
62 GB as the host f32 tree), :func:`colpali_granite_from_hf` the Granite one
(32.2 B), :func:`colpali_kimi_linear_from_hf` the Kimi-Linear one (28.3 B at
the benchmark's 16 layers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
from ..parallel.sp import gather_tokens, sp_mesh_for
from ..utils import graphs
from ..utils.graphs import ShapeGraphs
from .convert import _encoder_from_hf, _lin, _ln, _patch_w, _t, stack_layers
from . import granite, kimi_linear
from .decoder import RoutedLM, owned
from .deepseek import DeepseekConfig, DeepseekLM, layer_from_hf
from .gemma import Gemma, GemmaConfig
from .granite import GraniteConfig, GraniteLM
from .kimi_linear import KimiLinearConfig, KimiLinearLM
from .layers import linear
from .params import load_tree
from .registry import ModelInfo
from .towers import VisionConfig, VisionTower, seeded_generator


@dataclass(frozen=True)
class ColPaliConfig:
    vision: VisionConfig
    # the language model: Gemma, DeepSeek, Granite or Kimi-Linear
    gemma: GemmaConfig | DeepseekConfig | GraniteConfig | KimiLinearConfig
    embedding_dim: int = 128
    image_token_id: int = 256000


def _normalize_tokens(out: torch.Tensor) -> torch.Tensor:
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


class ColPali(nn.Module):
    """``vision``, ``mm_proj.{w,b}``, ``gemma``, ``emb_proj.{w,b}`` and the
    integer buffer ``image_suffix_ids`` (the image prompt's tokens, e.g.
    "<bos>Describe the image.\\n"); weights drawn from
    ``torch.Generator(seed)`` on ``device``."""

    def __init__(self, cfg: ColPaliConfig, image_suffix_ids, *, seed: int = 0, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        gen = seeded_generator(seed, device)

        def normal(shape):
            t = torch.randn(shape, generator=gen, device=device) * 0.02
            return nn.Parameter(t.to(dtype), requires_grad=False)

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device, dtype=dtype), requires_grad=False)

        self.vision = VisionTower(cfg.vision, gen=gen, device=device, dtype=dtype)
        self.mm_proj = nn.ParameterDict({"w": normal((cfg.vision.dim, cfg.gemma.dim)), "b": zeros(cfg.gemma.dim)})
        lm = {DeepseekConfig: DeepseekLM, GraniteConfig: GraniteLM, KimiLinearConfig: KimiLinearLM}.get(
            type(cfg.gemma), Gemma)
        self.gemma = lm(cfg.gemma, gen=gen, device=device, dtype=dtype)
        self.emb_proj = nn.ParameterDict({"w": normal((cfg.gemma.dim, cfg.embedding_dim)),
                                          "b": zeros(cfg.embedding_dim)})
        ids = torch.as_tensor(np.asarray(image_suffix_ids, np.int32), device=device)
        self.register_buffer("image_suffix_ids", ids)
        # the MoE decoders' caption batches on the card: CUDA graphs
        self.text_graphs = ShapeGraphs(self.gemma.tally) if isinstance(self.gemma, RoutedLM) else None

    def _apply(self, fn, *args, **kwargs):
        if self.text_graphs is not None:
            self.text_graphs.reset()  # the graphs read the tensors about to move
        return super()._apply(fn, *args, **kwargs)

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The 128-d head in f32, then per-token L2 normalization."""
        out = torch.matmul(hidden.float(), self.emb_proj["w"].float()) + self.emb_proj["b"].float()
        return _normalize_tokens(out)

    def image_fwd(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, S, 3] -> per-token embeddings [B, N + L_suffix, D] f32."""
        dtype = self.mm_proj["w"].dtype
        feats = self.vision(pixels).to(dtype)  # [B, N, Dv]
        proj = linear(feats, self.mm_proj["w"], self.mm_proj["b"])
        b = pixels.shape[0]
        suffix = self.gemma.embed_tokens(self.image_suffix_ids.expand(b, -1))
        x = torch.cat([proj, suffix.to(dtype)], dim=1)
        sp = sp_mesh_for(x.shape[1])
        return gather_tokens(self._head(self.gemma(x, sp=sp)), sp)

    def text_fwd(self, input_ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, T] -> per-token embeddings [B, T, D] f32, pad tokens
        exact zeros. The MoE decoders' batches on the card run as CUDA
        graphs (``utils/graphs.py``), their routes and expert loads handed to
        their sink and counts after each replay."""
        if mask is None:
            mask = torch.ones_like(input_ids)
        if self.text_graphs is None or not graphs.applies(input_ids):
            return self._text(input_ids, mask)
        out, routes, loads = self.text_graphs(self._text_routed, input_ids, mask)
        lm = self.gemma
        lm.expert_loads = loads if lm.expert_loads is None else lm.expert_loads.add_(loads)
        if lm.route_sink is not None:
            lm.route_sink.append(list(routes.unbind(0)))
        return out

    def _text_routed(self, input_ids: torch.Tensor, mask: torch.Tensor):
        """(``_text``'s output, the MoE decoder's chosen experts [MoE
        layers, B*T, k], its expert loads [MoE layers, E]), the last two made
        apart from the decoder's sink and counts: a forward that changes no
        state outside its outputs, which a graph can replay."""
        lm = self.gemma
        sink, loads = lm.route_sink, lm.expert_loads
        lm.route_sink, lm.expert_loads = [], None
        try:
            out = self._text(input_ids, mask)
            return out, torch.stack(lm.route_sink[0]), lm.expert_loads
        finally:
            lm.route_sink, lm.expert_loads = sink, loads

    def _text(self, input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        sp = sp_mesh_for(input_ids.shape[1])
        hidden = self.gemma(self.gemma.embed_tokens(input_ids), attn_mask=mask, sp=sp)
        return gather_tokens(self._head(hidden), sp) * mask[:, :, None].float()

    # the encoding engine's interface (models/encode.py)
    encode_image = image_fwd
    encode_text = text_fwd


# --- HF conversion -------------------------------------------------------------


def colpali_config_from_hf(hf_cfg) -> ColPaliConfig:
    vlm = hf_cfg.vlm_config
    v, t = vlm.vision_config, vlm.text_config
    return ColPaliConfig(
        vision=VisionConfig(
            image_size=v.image_size, patch_size=v.patch_size, dim=v.hidden_size,
            layers=v.num_hidden_layers, heads=v.num_attention_heads, mlp_dim=v.intermediate_size,
            proj_dim=None, style="siglip", act=v.hidden_act, ln_eps=v.layer_norm_eps, use_head=False,
        ),
        gemma=GemmaConfig(
            vocab_size=t.vocab_size, dim=t.hidden_size, layers=t.num_hidden_layers,
            heads=t.num_attention_heads, kv_heads=t.num_key_value_heads, head_dim=t.head_dim,
            mlp_dim=t.intermediate_size, rope_theta=t.rope_theta, rms_eps=t.rms_norm_eps,
        ),
        embedding_dim=hf_cfg.embedding_dim,
        image_token_id=vlm.image_token_index,
    )


def _gemma_from_hf(sd, prefix: str, n_layers: int) -> dict:
    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": _t(sd[f"{lp}.input_layernorm.weight"]),
            "attn": {n: _t(sd[f"{lp}.self_attn.{n}_proj.weight"]).T for n in ("q", "k", "v", "o")},
            "ln2": _t(sd[f"{lp}.post_attention_layernorm.weight"]),
            "mlp": {n: _t(sd[f"{lp}.mlp.{n}_proj.weight"]).T for n in ("gate", "up", "down")},
        })
    return {
        "embed": _t(sd[f"{prefix}.embed_tokens.weight"]),
        "layers": stack_layers(layers),
        "final_norm": _t(sd[f"{prefix}.norm.weight"]),
    }


def colpali_params_from_hf(sd, cfg: ColPaliConfig, image_suffix_ids: np.ndarray) -> dict:
    """HF ``ColPaliForRetrieval`` state dict -> the JAX package's param tree
    (numpy); ``image_suffix_ids`` stays an int32 leaf."""
    vt = "vlm.model.vision_tower.vision_model"
    vision = {
        "patch": {
            "w": _patch_w(_t(sd[f"{vt}.embeddings.patch_embedding.weight"])),
            "b": _t(sd[f"{vt}.embeddings.patch_embedding.bias"]),
        },
        "pos": _t(sd[f"{vt}.embeddings.position_embedding.weight"]),
        "encoder": _encoder_from_hf(sd, f"{vt}.encoder", cfg.vision.layers),
        "post_ln": _ln(sd, f"{vt}.post_layernorm"),
    }
    return {
        "vision": vision,
        "mm_proj": _lin(sd, "vlm.model.multi_modal_projector.linear"),
        "gemma": _gemma_from_hf(sd, "vlm.model.language_model", cfg.gemma.layers),
        "emb_proj": _lin(sd, "embedding_proj_layer"),
        "image_suffix_ids": np.asarray(image_suffix_ids, np.int32),
    }


def colpali_from_params(tree, cfg: ColPaliConfig, *, device, dtype=torch.float32) -> ColPali:
    """A ``ColPali`` holding a converted param tree's weights in ``dtype``
    (built on ``meta``: the tree's tensors are the only copy on ``device``)."""
    model = ColPali(cfg, tree["image_suffix_ids"], device="meta", dtype=dtype)
    return load_tree(model, tree, dtype, device=device)


VISION_PREFIX = "vlm.model.vision_tower.vision_model"
LM_PREFIX = "vlm.model.language_model"


def _vision_from_hf(sd: Mapping[str, torch.Tensor], cfg: VisionConfig, dtype) -> dict[str, torch.Tensor]:
    """The headless SigLIP tower's HF tensors present in ``sd`` -> this
    module's ``vision.*`` names, on their own device (``_encoder_from_hf``'s
    mapping, in torch)."""
    out = {}
    for key, x in sd.items():
        if not key.startswith(VISION_PREFIX + "."):
            continue
        name = key[len(VISION_PREFIX) + 1 :]
        if name == "embeddings.patch_embedding.weight":  # [D, C, p, p] -> [p*p*C, D]
            out["patch.w"] = x.permute(2, 3, 1, 0).reshape(-1, x.shape[0])
        elif name == "embeddings.patch_embedding.bias":
            out["patch.b"] = x
        elif name == "embeddings.position_embedding.weight":
            out["pos"] = x
        elif name.startswith("post_layernorm."):
            out["post_ln." + ("scale" if name.endswith("weight") else "bias")] = x
        elif name.startswith("encoder.layers."):
            _, _, i, *rest = name.split(".")
            mod, leaf = ".".join(rest[:-1]), rest[-1]
            norms = {"layer_norm1": "ln1", "layer_norm2": "ln2"}
            if mod in norms:
                out[f"encoder.layers.{i}.{norms[mod]}." + ("scale" if leaf == "weight" else "bias")] = x
            else:
                mod = {"self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k", "self_attn.v_proj": "attn.v",
                       "self_attn.out_proj": "attn.o", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}[mod]
                out[f"encoder.layers.{i}.{mod}." + ("w" if leaf == "weight" else "b")] = x.T if leaf == "weight" else x
        else:
            raise KeyError(f"unknown vision tensor {key}")
    return {f"vision.{k}": owned(v, dtype) for k, v in out.items()}


def colpali_deepseek_from_hf(parts: Iterable[Mapping[str, torch.Tensor]], cfg: ColPaliConfig, image_suffix_ids, *,
                             dtype) -> ColPali:
    """A ``ColPali`` with the DeepSeek decoder from HF-layout tensors
    (``vlm.model.vision_tower.vision_model.*``,
    ``vlm.model.multi_modal_projector.linear.*``,
    ``vlm.model.language_model.{embed_tokens,norm,layers.<i>}.*`` in
    ``DeepseekV3Model``'s names, ``embedding_proj_layer.*``), converted on
    their own device part by part: each part a mapping that holds whole
    layers, dropped by the caller once converted, so the model's weights
    and one part are all there is at once. Every weight must be filled."""
    return _colpali_from_hf_parts(parts, cfg, image_suffix_ids, dtype, layer_from_hf)


def colpali_granite_from_hf(parts: Iterable[Mapping[str, torch.Tensor]], cfg: ColPaliConfig, image_suffix_ids, *,
                            dtype) -> ColPali:
    """:func:`colpali_deepseek_from_hf` for the Granite decoder: its layers in
    ``GraniteMoeHybridModel``'s names under ``vlm.model.language_model``
    (``granite.layer_from_hf``)."""
    return _colpali_from_hf_parts(parts, cfg, image_suffix_ids, dtype, granite.layer_from_hf)


def colpali_kimi_linear_from_hf(parts: Iterable[Mapping[str, torch.Tensor]], cfg: ColPaliConfig, image_suffix_ids,
                                *, dtype) -> ColPali:
    """:func:`colpali_deepseek_from_hf` for the Kimi-Linear decoder: its layers
    in ``KimiDecoderLayer``'s names under ``vlm.model.language_model``
    (``kimi_linear.layer_from_hf``)."""
    return _colpali_from_hf_parts(parts, cfg, image_suffix_ids, dtype, kimi_linear.layer_from_hf)


def _colpali_from_hf_parts(parts, cfg: ColPaliConfig, image_suffix_ids, dtype, layer_fn) -> ColPali:
    model = ColPali(cfg, image_suffix_ids, device="meta", dtype=dtype)
    lm = cfg.gemma
    device = None
    for sd in parts:
        state = _vision_from_hf(sd, cfg.vision, dtype)
        for key, x in sd.items():
            device = x.device
            head, _, leaf = key.rpartition(".")
            if head in ("vlm.model.multi_modal_projector.linear", "embedding_proj_layer"):
                name = "mm_proj" if head.startswith("vlm") else "emb_proj"
                state[f"{name}.w" if leaf == "weight" else f"{name}.b"] = x.T if leaf == "weight" else x
            elif key == f"{LM_PREFIX}.embed_tokens.weight":
                state["gemma.embed"] = x
            elif key == f"{LM_PREFIX}.norm.weight":
                state["gemma.final_norm"] = x
        state = {k: owned(v, dtype) if k.startswith(("mm_", "emb_", "gemma.embed", "gemma.final")) else v
                 for k, v in state.items()}
        layers = {int(k[len(LM_PREFIX) + 8 :].split(".")[0]) for k in sd if k.startswith(f"{LM_PREFIX}.layers.")}
        for i in sorted(layers):
            state.update({f"gemma.{k}": v for k, v in layer_fn(sd, LM_PREFIX, lm, i, dtype).items()})
        unexpected = model.load_state_dict(state, strict=False, assign=True).unexpected_keys
        if unexpected:
            raise KeyError(f"tensors with no place in the model: {unexpected[:5]}")
    ids = torch.as_tensor(np.asarray(image_suffix_ids, np.int32), device=device)
    model.load_state_dict({"image_suffix_ids": ids}, strict=False, assign=True)
    left = [n for n, t in (*model.named_parameters(), *model.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"ColPali: not filled by the HF tensors: {left[:5]}")
    return model


def load_colpali(info: ModelInfo, *, device, dtype=torch.bfloat16, checkpoint_dir: str | None = None):
    """Load an HF ColPali checkpoint (the HF cache or ``checkpoint_dir``)."""
    from transformers import AutoProcessor, ColPaliForRetrieval

    from .colpali_processing import colpali_query_tokenizer, image_prompt_suffix_ids, prompts_from_processor
    from .zoo import LoadedModel

    src = checkpoint_dir or info.hf_id
    hf = ColPaliForRetrieval.from_pretrained(src, torch_dtype=torch.float32)
    cfg = colpali_config_from_hf(hf.config)
    # only the raw tokenizer and the prompt constants come from the HF
    # processor; the query and image wrapping is colpali_processing.py's
    proc = AutoProcessor.from_pretrained(src, trust_remote_code=info.trust_remote_code)
    prompts = prompts_from_processor(proc)
    tree = colpali_params_from_hf(hf.state_dict(), cfg, image_prompt_suffix_ids(proc.tokenizer, prompts))
    del hf
    return LoadedModel(
        info=info, cfg=cfg, model=colpali_from_params(tree, cfg, device=device, dtype=dtype),
        preprocess=info.preprocess, tokenize=colpali_query_tokenizer(proc.tokenizer, prompts), multi_vector=True,
    )


def debug_colpali_config(image_size: int = 28, decoder: str = "gemma") -> ColPaliConfig:
    """The debug ColPali; ``decoder`` "deepseek": its language model the
    DeepSeek decoder at width 64, one dense layer then 2 MoE layers of 8
    experts, top-2, 2 shared; "granite": the Granite decoder at width 64, 3
    Mamba-2 layers (16 heads of 8, state 16, chunk 8) and one attention layer
    (4 heads of 16, 2 KV heads), 8 experts of 32 at top-2 and a shared 48;
    "kimi_linear": the Kimi-Linear decoder at width 64, layers KDA, KDA, KDA,
    MLA, KDA (KDA 4 heads of 16, MLA as the DeepSeek one's, unrotated), the
    first with a dense MLP of 96, then 8 experts of 32 at top-2 and one shared."""
    if decoder == "kimi_linear":
        lm = KimiLinearConfig(vocab_size=512, dim=64, layers=5, heads=4, mlp_dim=96, moe_dim=32, n_experts=8, top_k=2,
                              n_shared=1, kv_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16, rope_theta=10000.0,
                              kda_layers=(0, 1, 2, 4), kda_heads=4, kda_head_dim=16)
    elif decoder == "granite":
        lm = GraniteConfig(vocab_size=512, dim=64, layer_types=("mamba", "attention", "mamba", "mamba"), heads=4,
                           kv_heads=2, moe_dim=32, n_experts=8, top_k=2, shared_dim=48, ssm_heads=16, ssm_head_dim=8,
                           state=16, chunk=8, attention_multiplier=1 / 16)
    elif decoder == "deepseek":
        lm = DeepseekConfig(vocab_size=512, dim=64, layers=3, heads=4, mlp_dim=96, moe_dim=32, n_experts=8, top_k=2,
                            n_shared=2, kv_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16, rope_theta=10000.0)
    else:
        lm = GemmaConfig(vocab_size=512, dim=48, layers=2, heads=4, kv_heads=1, head_dim=16, mlp_dim=96)
    return ColPaliConfig(
        vision=VisionConfig(
            image_size=image_size, patch_size=14, dim=32, layers=2, heads=4, mlp_dim=64,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6, use_head=False,
        ),
        gemma=lm,
        embedding_dim=16,
        image_token_id=500,
    )


def load_debug_colpali(info: ModelInfo, seed: int = 0, *, device, dtype=torch.float32):
    """Random-init small ColPali (28 px images, 4 patches) for offline runs;
    the DeepSeek, Granite and Kimi-Linear variants (``info.decoder``) query through
    ColPali's prompt on the word tokenizer."""
    from .arch import colpali_word_tokenizer
    from .zoo import LoadedModel, hash_tokenizer

    cfg = debug_colpali_config(decoder=info.decoder)
    pre = PreprocessConfig(image_size=cfg.vision.image_size, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD)
    vocab = cfg.gemma.vocab_size
    moe = info.decoder in ("deepseek", "granite", "kimi_linear")
    tokenize = colpali_word_tokenizer(vocab) if moe else hash_tokenizer(vocab, 16, vocab - 1)
    return LoadedModel(
        info=info,
        cfg=cfg,
        model=ColPali(cfg, np.array([1, 7, 8, 9], np.int32), seed=seed, device=device, dtype=dtype),
        preprocess=pre,
        tokenize=tokenize,
        multi_vector=True,
        weights_provenance="debug-random",
    )
