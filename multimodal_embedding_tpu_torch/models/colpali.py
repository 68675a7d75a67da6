"""ColPali: the PaliGemma-based multi-vector late-interaction retriever.

Counterpart of ``multimodal_embedding_tpu/models/colpali.py``:

- vision: the headless SigLIP tower (``towers.py``, ``use_head=False``) ->
  [B, N, Dv];
- multimodal projector: a linear to the Gemma width, its bias added before
  the cast to the model dtype (HF PaliGemma's 1/sqrt(dim) on image features
  cancels Gemma's sqrt(dim) on the merged embeddings, so image features
  enter the decoder at projector scale; text embeddings carry the scale);
- language model: Gemma (``gemma.py``) over [image features | prompt suffix]
  with PaliGemma's inference mask (every token attends to every valid token);
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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig
from ..parallel.sp import gather_tokens, sp_mesh_for
from .convert import _encoder_from_hf, _lin, _ln, _patch_w, _t, stack_layers
from .gemma import Gemma, GemmaConfig
from .layers import linear
from .params import load_tree
from .registry import ModelInfo
from .towers import VisionConfig, VisionTower, seeded_generator


@dataclass(frozen=True)
class ColPaliConfig:
    vision: VisionConfig
    gemma: GemmaConfig
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
        self.gemma = Gemma(cfg.gemma, gen=gen, device=device, dtype=dtype)
        self.emb_proj = nn.ParameterDict({"w": normal((cfg.gemma.dim, cfg.embedding_dim)),
                                          "b": zeros(cfg.embedding_dim)})
        ids = torch.as_tensor(np.asarray(image_suffix_ids, np.int32), device=device)
        self.register_buffer("image_suffix_ids", ids)

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
        exact zeros."""
        if mask is None:
            mask = torch.ones_like(input_ids)
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


def debug_colpali_config(image_size: int = 28) -> ColPaliConfig:
    return ColPaliConfig(
        vision=VisionConfig(
            image_size=image_size, patch_size=14, dim=32, layers=2, heads=4, mlp_dim=64,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6, use_head=False,
        ),
        gemma=GemmaConfig(vocab_size=512, dim=48, layers=2, heads=4, kv_heads=1, head_dim=16, mlp_dim=96),
        embedding_dim=16,
        image_token_id=500,
    )


def load_debug_colpali(info: ModelInfo, seed: int = 0, *, device, dtype=torch.float32):
    """Random-init small ColPali (28 px images, 4 patches) for offline runs."""
    from .zoo import LoadedModel, hash_tokenizer

    cfg = debug_colpali_config()
    pre = PreprocessConfig(image_size=cfg.vision.image_size, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD)
    return LoadedModel(
        info=info,
        cfg=cfg,
        model=ColPali(cfg, np.array([1, 7, 8, 9], np.int32), seed=seed, device=device, dtype=dtype),
        preprocess=pre,
        tokenize=hash_tokenizer(cfg.gemma.vocab_size, 16, cfg.gemma.vocab_size - 1),
        multi_vector=True,
        weights_provenance="debug-random",
    )
