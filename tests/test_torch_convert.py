"""The port's HF converters against the JAX package's, and its converted
models against the HF (or reference) torch models, on the CPU.

- Random-weight HF ``CLIPModel`` and ``SiglipModel`` built from small configs
  here (nothing from the hub), and the Jina-CLIP reference of
  ``tests/jina_torch_reference.py`` in the checkpoint's key layout: the port's
  converter gives the JAX converter's config and param tree, the same keys,
  shapes and dtypes and the same values (tolerance 0).
- The converted port modules match the torch models in f32: rtol and atol
  1e-4 (Jina: 1e-4 and 1e-5, as ``tests/test_jina.py``), for both of HF
  CLIP's EOS conventions, SigLIP's MAP head and a ragged patch grid.
- Jina's strict converter rejects a missing and an unknown key and accepts
  the known non-weights.
- Every full-width manifest of ``tests/manifests`` (the four CLIP models,
  SigLIP-400M, ColPali-v1.3 and Jina-CLIP-v1) is consumed by the port's
  converter, and the tree loads into the port's module, built on the
  ``meta`` device, with ``strict=True``. ColPali is converted at two layers
  of each stack (full widths; a full f16 tree is 7 GB), and every key of its
  manifest is held against what that conversion read.
"""

import dataclasses
import gc
import re

import jax
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import convert as jconv
from multimodal_embedding_tpu.models import jina as jjina
from multimodal_embedding_tpu_torch.models import convert as tconv
from multimodal_embedding_tpu_torch.models import jina as tjina
from multimodal_embedding_tpu_torch.models.arch import full_arch_config, full_colpali_config, full_jina_config
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.models.zoo import dual_encoder_from_params
from tests.test_convert_manifest import ManifestStateDict

RTOL = ATOL = 1e-4


def flat_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': numpy leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_same_tree(port_tree, jax_tree) -> None:
    """Same keys, shapes, dtypes and values (tolerance 0)."""
    got, want = flat_tree(port_tree), flat_tree(jax.tree.map(np.asarray, jax_tree))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, (k, got[k].shape, got[k].dtype, w.shape, w.dtype)
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def hub_offline(monkeypatch) -> None:
    """Make any HF hub lookup raise at once instead of reaching the network:
    the flags are read when huggingface_hub and transformers are imported,
    so setting the environment alone would come too late."""
    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)


def assert_same_config(port_cfg, jax_cfg) -> None:
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def _clip_hf(eos_token_id: int, seed: int):
    from transformers import CLIPConfig, CLIPModel

    hf_cfg = CLIPConfig(
        text_config={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                     "intermediate_size": 64, "vocab_size": 99, "max_position_embeddings": 16,
                     "hidden_act": "quick_gelu", "eos_token_id": eos_token_id},
        vision_config={"hidden_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
                       "intermediate_size": 96, "image_size": 32, "patch_size": 8, "hidden_act": "quick_gelu"},
        projection_dim=24,
    )
    torch.manual_seed(seed)
    return CLIPModel(hf_cfg).eval()


def _siglip_hf(image_size: int, patch_size: int, layers: int, seed: int):
    from transformers import SiglipConfig, SiglipModel

    hf_cfg = SiglipConfig(
        text_config={"hidden_size": 32, "num_hidden_layers": layers, "num_attention_heads": 4,
                     "intermediate_size": 64, "vocab_size": 99, "max_position_embeddings": 16},
        vision_config={"hidden_size": 48, "num_hidden_layers": layers, "num_attention_heads": 4,
                       "intermediate_size": 96, "image_size": image_size, "patch_size": patch_size},
    )
    torch.manual_seed(seed)
    return SiglipModel(hf_cfg).eval()


# legacy eos_token_id 2 pools at argmax(ids); a real id at its first occurrence
CLIP_EOS = [2, 97]
SIGLIP_GEOMETRY = [(32, 8, 2), (30, 14, 1)]  # (image, patch, layers); 30/14 drops trailing pixels


@pytest.fixture(scope="module", params=CLIP_EOS, ids=lambda e: f"eos{e}")
def clip_pair(request):
    hf = _clip_hf(request.param, seed=0)
    cfg = tconv.clip_config_from_hf(hf.config)
    tree = tconv.clip_params_from_hf(hf.state_dict(), cfg)
    return hf, cfg, tree


@pytest.fixture(scope="module", params=SIGLIP_GEOMETRY, ids=lambda g: f"{g[0]}px_p{g[1]}")
def siglip_pair(request):
    hf = _siglip_hf(*request.param, seed=1)
    cfg = tconv.siglip_config_from_hf(hf.config)
    tree = tconv.siglip_params_from_hf(hf.state_dict(), cfg)
    return hf, cfg, tree


def test_clip_converter_matches_jax(clip_pair):
    hf, cfg, tree = clip_pair
    jcfg = jconv.clip_config_from_hf(hf.config)
    assert_same_config(cfg, jcfg)
    assert_same_tree(tree, jconv.clip_params_from_hf(hf.state_dict(), jcfg))


def test_siglip_converter_matches_jax(siglip_pair):
    hf, cfg, tree = siglip_pair
    jcfg = jconv.siglip_config_from_hf(hf.config)
    assert_same_config(cfg, jcfg)
    assert_same_tree(tree, jconv.siglip_params_from_hf(hf.state_dict(), jcfg))


def test_converters_take_numpy_state_dicts(clip_pair):
    hf, cfg, tree = clip_pair
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    assert_same_tree(tconv.clip_params_from_hf(sd, cfg), tree)


def test_clip_image_matches_hf(clip_pair):
    hf, cfg, tree = clip_pair
    model = dual_encoder_from_params(tree, cfg, device="cpu")
    px = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf.get_image_features(pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2))).numpy()
        ours = model.encode_image(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_clip_text_matches_hf(clip_pair):
    """Legacy EOS 2: the highest id (98) pools, the first of two. A real EOS
    id (97): its first occurrence pools, later copies pad the row."""
    hf, cfg, tree = clip_pair
    eos = cfg.text.eos_token_id
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 97, size=(4, 12))
    if eos == 2:
        ids[:, -1] = 98
        ids[1, 7] = 98
    else:
        for row, end in enumerate((11, 5, 8, 2)):
            ids[row, end:] = eos
    model = dual_encoder_from_params(tree, cfg, device="cpu")
    with torch.no_grad():
        ref = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
        ours = model.encode_text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_siglip_image_matches_hf(siglip_pair):
    hf, cfg, tree = siglip_pair
    s = cfg.vision.image_size
    px = np.random.default_rng(2).standard_normal((2, s, s, 3)).astype(np.float32)
    model = dual_encoder_from_params(tree, cfg, device="cpu")
    with torch.no_grad():
        ref = hf.get_image_features(pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2))).numpy()
        ours = model.encode_image(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_siglip_text_matches_hf(siglip_pair):
    hf, cfg, tree = siglip_pair
    ids = np.random.default_rng(3).integers(3, 99, size=(4, 16))
    model = dual_encoder_from_params(tree, cfg, device="cpu")
    with torch.no_grad():
        ref = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
        ours = model.encode_text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


# --- Jina-CLIP-v1 ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jina_ref():
    """The reference in the checkpoint's key layout (64-d heads, so the
    config derivation runs), with its head bias and token-type table."""
    from tests.jina_torch_reference import Eva02Torch, JinaBertTorch, JinaClipTorch

    torch.manual_seed(0)
    vision = Eva02Torch(image_size=32, patch_size=16, dim=128, layers=2, heads=2, mlp_dim=160, proj_dim=64)
    with torch.no_grad():
        vision.cls_token.normal_(std=0.02)
        vision.pos_embed.normal_(std=0.02)
    bert = JinaBertTorch(vocab=128, dim=128, layers=2, heads=2, mlp_dim=192)
    with torch.no_grad():
        bert.embeddings.token_type_embeddings.weight.normal_(std=0.02)
    return JinaClipTorch(vision, bert).eval()


def test_jina_converter_matches_jax(jina_ref):
    sd = jina_ref.state_dict()
    cfg, jcfg = tjina.jina_config_from_sd(sd), jjina.jina_config_from_sd(sd)
    assert_same_config(cfg, jcfg)
    assert cfg.vision.heads == 2 and cfg.vision.mlp_dim == 160 and cfg.text.mlp_dim == 192
    tree = tjina.jina_params_from_hf(sd, cfg)
    assert "proj_b" in tree["vision"]
    assert_same_tree(tree, jjina.jina_params_from_hf(sd, jcfg))


def test_jina_matches_reference(jina_ref):
    sd = jina_ref.state_dict()
    cfg = tjina.jina_config_from_sd(sd)
    model = tjina.jina_from_params(tjina.jina_params_from_hf(sd, cfg), cfg, device="cpu")
    rng = np.random.default_rng(4)
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 128, size=(3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    mask[1, 9:] = 0  # right padding
    with torch.no_grad():
        ref_img = jina_ref.encode_image(torch.from_numpy(px.transpose(0, 3, 1, 2))).numpy()
        ref_txt = jina_ref.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        img = model.encode_image(torch.from_numpy(px)).numpy()
        txt = model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(img, ref_img, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(txt, ref_txt, rtol=1e-4, atol=1e-5)


def test_jina_converter_rejects_a_missing_key(jina_ref):
    sd = dict(jina_ref.state_dict())
    cfg = tjina.jina_config_from_sd(sd)
    del sd["vision_model.blocks.1.mlp.w3.weight"]
    with pytest.raises(KeyError, match="blocks.1.mlp.w3.weight"):
        tjina.jina_params_from_hf(sd, cfg)


def test_jina_converter_rejects_an_unknown_key(jina_ref):
    sd = dict(jina_ref.state_dict())
    cfg = tjina.jina_config_from_sd(sd)
    sd["text_model.transformer.encoder.layer.0.mlp.extra_gate.weight"] = sd[
        "text_model.transformer.encoder.layer.0.mlp.wo.bias"]
    with pytest.raises(ValueError, match="extra_gate"):
        tjina.jina_params_from_hf(sd, cfg)


def test_jina_converter_ignores_known_non_weights(jina_ref):
    sd = dict(jina_ref.state_dict())  # holds the unused pooler.* keys
    cfg = tjina.jina_config_from_sd(sd)
    sd["logit_scale"] = torch.tensor(2.6592)
    sd["vision_model.rope.freqs_cos"] = torch.zeros(4)
    sd["text_model.transformer.embeddings.position_ids"] = torch.arange(4)
    assert any(k.startswith("text_model.transformer.pooler.") for k in sd)
    tree = tjina.jina_params_from_hf(sd, cfg)
    assert_same_tree(tree, tjina.jina_params_from_hf(jina_ref.state_dict(), cfg))


# --- full-width manifests ------------------------------------------------------------


def _load_on_meta(module: torch.nn.Module, tree) -> None:
    """Strict load of the tree's names and shapes into a ``meta`` module."""
    state = params_from_jax(tree, device="meta")
    module.load_state_dict(state, strict=True)
    for name, t in module.state_dict().items():
        assert tuple(t.shape) == tuple(state[name].shape), name


# HF keys no converter reads: the contrastive temperature (and SigLIP's bias)
UNREAD = {"logit_scale", "logit_bias"}


@pytest.mark.parametrize("name", ["OpenAI-CLIP-L", "LAION-CLIP-H", "MetaCLIP-H14", "Apple-DFN5B-H", "SigLIP-400M"])
def test_dense_manifest_loads_strictly(name):
    cfg = full_arch_config(name)
    sd = ManifestStateDict(name)
    convert = tconv.siglip_params_from_hf if cfg.family == "siglip" else tconv.clip_params_from_hf
    tree = convert(sd, cfg)
    assert set(sd.shapes) - sd.accessed <= UNREAD, sorted(set(sd.shapes) - sd.accessed - UNREAD)[:5]
    _load_on_meta(DualEncoder(cfg, device="meta"), tree)
    del tree
    gc.collect()


def test_jina_manifest_loads_strictly():
    sd = ManifestStateDict("Jina-CLIP-v1")
    cfg = tjina.jina_config_from_sd(sd)
    assert cfg == full_jina_config()
    tree = tjina.jina_params_from_hf(sd, cfg)
    model = tjina.JinaClip(cfg, device="meta")
    model.vision.proj_b = torch.nn.Parameter(torch.empty(cfg.vision.proj_dim, device="meta"), requires_grad=False)
    _load_on_meta(model, tree)
    del tree
    gc.collect()


_LAYER = re.compile(r"\.(layers|layer|blocks)\.(\d+)\.")


def test_colpali_manifest_loads_strictly():
    """Two layers of SigLIP and of Gemma at full width; every other layer's
    keys are the same names as layer 0's."""
    from multimodal_embedding_tpu_torch.models.colpali import ColPali, colpali_params_from_hf

    full = full_colpali_config()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, layers=2),
                              gemma=dataclasses.replace(full.gemma, layers=2))
    sd = ManifestStateDict("ColPali-v1.3")
    layers_of = {}
    for k in sd.shapes:
        if m := _LAYER.search(k):
            layers_of.setdefault(_LAYER.sub(".{i}.", k, count=1), set()).add(int(m.group(2)))
    sd.shapes = {k: v for k, v in sd.shapes.items() if not (m := _LAYER.search(k)) or int(m.group(2)) < 2}
    suffix = np.array([2, 10, 11, 12, 13, 14], np.int32)
    tree = colpali_params_from_hf(sd, cfg, suffix)
    read = {_LAYER.sub(".{i}.", k, count=1) for k in sd.accessed}
    # every layer key of the checkpoint is one the converter reads, at every depth it has
    for pattern, depths in layers_of.items():
        assert pattern in read, pattern
        want = full.vision.layers if "vision_tower" in pattern else full.gemma.layers
        assert depths == set(range(want)), pattern
    # left unread: the tied LM head (the embedding table) and the MAP head of
    # the SigLIP tower, which PaliGemma does not run
    unread = set(sd.shapes) - sd.accessed
    assert "vlm.lm_head.weight" in unread
    assert all(k == "vlm.lm_head.weight" or ".vision_model.head." in k for k in unread), sorted(unread)
    _load_on_meta(ColPali(cfg, suffix, device="meta"), tree)
    del tree
    gc.collect()
