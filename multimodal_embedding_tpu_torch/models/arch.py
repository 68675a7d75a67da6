"""Full-scale architecture configs, for runs without checkpoint weights.

Counterpart of ``multimodal_embedding_tpu/models/arch.py``: the architecture,
and so the performance envelope, of the HF checkpoint the reference loads;
only the weights are random. Sources: the HF config.json of each model id.
"""

from __future__ import annotations

import numpy as np
import torch

from .towers import DualEncoder, DualEncoderConfig, TextConfig, VisionConfig


def _clip(
    *, img: int, v_dim: int, v_layers: int, v_heads: int, v_mlp: int, patch: int,
    t_dim: int, t_layers: int, t_heads: int, t_mlp: int, proj: int, act: str,
) -> DualEncoderConfig:
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=img, patch_size=patch, dim=v_dim, layers=v_layers, heads=v_heads,
            mlp_dim=v_mlp, proj_dim=proj, style="clip", act=act,
        ),
        text=TextConfig(
            vocab_size=49408, max_len=77, dim=t_dim, layers=t_layers, heads=t_heads,
            mlp_dim=t_mlp, proj_dim=proj, style="clip", act=act, eos_token_id=2,
        ),
        family="clip",
    )


def _vit_h(img: int, act: str) -> DualEncoderConfig:
    return _clip(
        img=img, v_dim=1280, v_layers=32, v_heads=16, v_mlp=5120, patch=14,
        t_dim=1024, t_layers=24, t_heads=16, t_mlp=4096, proj=1024, act=act,
    )


def _siglip(*, img: int, patch: int, dim: int, layers: int, heads: int, mlp: int) -> DualEncoderConfig:
    return DualEncoderConfig(
        vision=VisionConfig(
            image_size=img, patch_size=patch, dim=dim, layers=layers, heads=heads, mlp_dim=mlp,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
        ),
        text=TextConfig(
            vocab_size=32000, max_len=64, dim=dim, layers=layers, heads=heads, mlp_dim=mlp,
            proj_dim=dim, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
        ),
        family="siglip",
    )


FULL_ARCH_CONFIGS: dict[str, DualEncoderConfig] = {
    # openai/clip-vit-large-patch14-336
    "OpenAI-CLIP-L": _clip(
        img=336, v_dim=1024, v_layers=24, v_heads=16, v_mlp=4096, patch=14,
        t_dim=768, t_layers=12, t_heads=12, t_mlp=3072, proj=768, act="quick_gelu",
    ),
    # laion/CLIP-ViT-H-14-laion2B-s32B-b79K (open_clip -> gelu)
    "LAION-CLIP-H": _vit_h(224, "gelu"),
    # facebook/metaclip-h14-fullcc2.5b (OpenAI arch -> quick_gelu)
    "MetaCLIP-H14": _vit_h(224, "quick_gelu"),
    # apple/DFN5B-CLIP-ViT-H-14-378 (open_clip -> gelu)
    "Apple-DFN5B-H": _vit_h(378, "gelu"),
    # google/siglip-so400m-patch14-384
    "SigLIP-400M": _siglip(img=384, patch=14, dim=1152, layers=27, heads=16, mlp=4304),
    # google/siglip-base-patch16-224 (outside the default "all" set)
    "SigLIP-Base": _siglip(img=224, patch=16, dim=768, layers=12, heads=12, mlp=3072),
}


def full_arch_config(name: str) -> DualEncoderConfig:
    return FULL_ARCH_CONFIGS[name]


def full_colpali_config():
    """vidore/colpali-v1.3: PaliGemma-3B (SigLIP-So400m/14-448 + Gemma-2B)
    with a 128-d retrieval head."""
    from .colpali import ColPaliConfig
    from .gemma import GemmaConfig

    return ColPaliConfig(
        vision=VisionConfig(
            image_size=448, patch_size=14, dim=1152, layers=27, heads=16, mlp_dim=4304,
            proj_dim=None, style="siglip", act="gelu_pytorch_tanh", ln_eps=1e-6,
            use_head=False,
        ),
        gemma=GemmaConfig(
            vocab_size=257216, dim=2048, layers=18, heads=8, kv_heads=1, head_dim=256,
            mlp_dim=16384,
        ),
        embedding_dim=128,
        image_token_id=257152,
    )


def full_colpali_deepseek_config():
    """ColPali-v1.3's SigLIP-So400m/14-448 tower, projector and 128-d head
    around Kimi-VL-A3B-Instruct's language model
    (huggingface.co/moonshotai/Kimi-VL-A3B-Instruct ``config.json``
    ``text_config``): a DeepSeek-V3 decoder of 27 layers at width 2048, the
    first dense (SwiGLU 11264), then 64 routed experts of width 1408, 6 a
    token, and 2 shared; MLA with a 512 latent, 16 heads of 128 + 64 (q, k)
    and 128 (v), rope theta 800000; vocabulary 163840."""
    from .colpali import ColPaliConfig
    from .deepseek import DeepseekConfig

    base = full_colpali_config()
    lm = DeepseekConfig(vocab_size=163840, dim=2048, layers=27, heads=16, mlp_dim=11264, moe_dim=1408, n_experts=64,
                        top_k=6, n_shared=2, first_dense=1, kv_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128,
                        routed_scale=2.446, norm_topk=True, rope_theta=800000.0, rms_eps=1e-5)
    return ColPaliConfig(vision=base.vision, gemma=lm, embedding_dim=base.embedding_dim,
                         image_token_id=163605)  # Kimi-VL's media placeholder id


def full_colpali_granite_config():
    """ColPali-v1.3's SigLIP-So400m/14-448 tower, projector and 128-d head
    around Granite-4.0-H-Small's language model
    (huggingface.co/ibm-granite/granite-4.0-h-small ``config.json``): 40
    layers at width 4096, 36 Mamba-2 (128 heads of 64, state 128, conv 4,
    expand 2, chunk 256) and 4 NoPE GQA attention layers at 5, 15, 25 and 35
    (32 heads, 8 KV heads, Dh 128, scale 1/128), each with 72 routed experts
    of width 768, 10 a token, and a shared expert of 1536; embedding
    multiplier 12, residual multiplier 0.22; vocabulary 100352."""
    from .colpali import ColPaliConfig
    from .granite import GraniteConfig

    base = full_colpali_config()
    types = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))
    lm = GraniteConfig(vocab_size=100352, dim=4096, layer_types=types, heads=32, kv_heads=8, moe_dim=768,
                       n_experts=72, top_k=10, shared_dim=1536, ssm_heads=128, ssm_head_dim=64, state=128,
                       conv_width=4, expand=2, chunk=256, embedding_multiplier=12.0, residual_multiplier=0.22,
                       attention_multiplier=0.0078125, rms_eps=1e-5)
    return ColPaliConfig(vision=base.vision, gemma=lm, embedding_dim=base.embedding_dim, image_token_id=100351)


def full_colpali_kimi_linear_config():
    """ColPali-v1.3's SigLIP-So400m/14-448 tower, projector and 128-d head
    around Kimi-Linear-48B-A3B-Instruct's language model
    (huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct ``config.json``)
    cut to its first 16 layers: at width 2304, KDA layers (32 heads of 128,
    conv 4) and MLA layers without rope (kv rank 512, q/k 128 + 64, v 128, 32
    heads) three to one, the MLA at layers 4, 8, 12 and 16 (1-based), the
    first layer a dense SwiGLU of 9216 and every later one 256 routed experts
    of width 1024, 8 a token, and one shared; vocabulary 163840. The whole 27
    layers (48.75 B parameters, 97.5 GB in bf16) do not fit one card; these
    16 are the benchmark's first pipeline stage (28.3 B, 56.7 GB)."""
    from .colpali import ColPaliConfig
    from .kimi_linear import KimiLinearConfig

    base = full_colpali_config()
    kda = tuple(i for i in range(16) if i % 4 != 3)
    lm = KimiLinearConfig(vocab_size=163840, dim=2304, layers=16, heads=32, mlp_dim=9216, moe_dim=1024,
                          n_experts=256, top_k=8, n_shared=1, first_dense=1, kv_rank=512, qk_nope_dim=128,
                          qk_rope_dim=64, v_dim=128, routed_scale=2.446, norm_topk=True, rope_theta=10000.0,
                          rms_eps=1e-5, nope=True, kda_layers=kda, kda_heads=32, kda_head_dim=128, conv_width=4)
    return ColPaliConfig(vision=base.vision, gemma=lm, embedding_dim=base.embedding_dim, image_token_id=163605)


def full_jina_config():
    """jinaai/jina-clip-v1: EVA02-B/16 + JinaBERT-base."""
    from .jina import Eva02Config, JinaBertConfig, JinaClipConfig

    return JinaClipConfig(vision=Eva02Config(), text=JinaBertConfig())


COLPALI_IMAGE_SUFFIX = (2, 10, 11, 12, 13, 14)  # the arch ColPalis' 6-token image prompt suffix
COLPALI_AUGMENTATION = 10  # ColPali's query augmentation tokens


def colpali_word_tokenizer(vocab_size: int):
    """ColPali's query prompt (``colpali_processing.process_queries_ids``:
    ``<bos> + "Query: " + text + <pad> * 10 + "\\n"``, padded to the batch's
    longest) on the word tokenizer: BOS 1, one id a lower-cased word of
    "query: " + text (``2 + hash(word) % (vocab - 3)``), ten augmentation
    tokens of id 0 that are attended (mask 1), the newline as id vocab - 1,
    then zeros with mask 0 to the longest. No truncation, as the processor's."""

    def tokenize(texts: list[str]):
        rows = [[1] + [2 + hash(w) % (vocab_size - 3) for w in ("query: " + t).lower().split()]
                + [0] * COLPALI_AUGMENTATION + [vocab_size - 1] for t in texts]
        n = max(len(r) for r in rows)
        ids = np.zeros((len(rows), n), np.int32)
        mask = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

    return tokenize


def arch_tokenizer(info, cfg):
    """The offline word-hash tokenizer of an arch model: ColPali's 32-token
    prompts (the DeepSeek, Granite and Kimi-Linear ColPalis: ColPali's query prompt,
    :func:`colpali_word_tokenizer`), Jina's registry length with its EOS id 3, and each dual
    encoder's text length with the CLIP EOS id 49407. That id is past the end
    of SigLIP's 32000-row table, where the JAX package's gather clamps it to
    the last row: so the id is ``min(49407, vocab - 1)``, the row JAX reads."""
    from .zoo import hash_tokenizer

    if info.type == "colpali" and info.decoder in ("deepseek", "granite", "kimi_linear"):
        return colpali_word_tokenizer(cfg.gemma.vocab_size)
    if info.type == "colpali":
        return hash_tokenizer(cfg.gemma.vocab_size, 32, 1)
    if info.type == "jina":
        return hash_tokenizer(cfg.text.vocab_size, info.text_max_len, 3)
    return hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, min(49407, cfg.text.vocab_size - 1))


def load_arch_model(name: str, seed: int = 0, *, device, dtype=torch.bfloat16):
    """Random-init model at the FULL published architecture (throughput is
    weight-independent). The weights are drawn on ``device``."""
    from .registry import model_info
    from .zoo import LoadedModel

    info = model_info(name)
    if info.type == "jina":
        from .jina import JinaClip

        cfg = full_jina_config()
        return LoadedModel(
            info=info, cfg=cfg, model=JinaClip(cfg, seed=seed, device=device, dtype=dtype),
            preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg), weights_provenance="arch-random",
        )
    if info.type == "colpali":
        from .colpali import ColPali

        cfg = {"deepseek": full_colpali_deepseek_config, "granite": full_colpali_granite_config,
               "kimi_linear": full_colpali_kimi_linear_config}.get(info.decoder, full_colpali_config)()
        suffix = np.array(COLPALI_IMAGE_SUFFIX, np.int32)
        return LoadedModel(
            info=info, cfg=cfg, model=ColPali(cfg, suffix, seed=seed, device=device, dtype=dtype),
            preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg),
            multi_vector=True, weights_provenance="arch-random",
        )
    cfg = full_arch_config(name)
    return LoadedModel(
        info=info, cfg=cfg, model=DualEncoder(cfg, seed=seed, device=device, dtype=dtype),
        preprocess=info.preprocess, tokenize=arch_tokenizer(info, cfg), weights_provenance="arch-random",
    )
