"""The port's native checkpoint cache, ``load_model`` and the CLI's
real-checkpoint path, on the CPU, offline.

- ``models/checkpoint.py`` writes the JAX package's ``.npz`` format: a port
  round trip gives the same config and tree and identical embeddings; a file
  written by the JAX package's ``save_params`` loads in the port (the same
  config, embeddings within 1e-5 of JAX's), and one written by the port loads
  in JAX's ``load_params`` (the same tree, JAX embeddings identical to those
  from the tree it was converted from).
- ``load_model`` from a ``save_pretrained`` directory writes the f32 cache,
  and a second load reads it with transformers' model class patched out
  (dense and siglip). ColPali and Jina dispatch to their own loaders.
- The CLI with ``--device cpu --native-cache-dir`` and neither debug flag:
  one CSV row with ``Weights`` = ``real``; a model whose load fails is logged
  and skipped.

The HF tokenizer is replaced by the word-hash tokenizer, as in
``tests/test_tower_parity.py``: no tokenizer files exist offline.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import transformers

from multimodal_embedding_tpu.models import checkpoint as jckpt
from multimodal_embedding_tpu.models import convert as jconv
from multimodal_embedding_tpu.models.towers import encode_image as jax_encode_image
from multimodal_embedding_tpu.models.towers import encode_text as jax_encode_text
from multimodal_embedding_tpu_torch.cli import main as tcli
from multimodal_embedding_tpu_torch.models import checkpoint as tckpt
from multimodal_embedding_tpu_torch.models import convert as tconv
from multimodal_embedding_tpu_torch.models import zoo
from multimodal_embedding_tpu_torch.models.registry import model_info
from tests.test_torch_convert import assert_same_tree, flat_tree, hub_offline


def _clip_hf(image_size=32, patch_size=8, seed=0):
    hf_cfg = transformers.CLIPConfig(
        text_config={"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
                     "intermediate_size": 64, "vocab_size": 99, "max_position_embeddings": 16,
                     "hidden_act": "quick_gelu", "eos_token_id": 2},
        vision_config={"hidden_size": 48, "num_hidden_layers": 1, "num_attention_heads": 4,
                       "intermediate_size": 96, "image_size": image_size, "patch_size": patch_size,
                       "hidden_act": "quick_gelu"},
        projection_dim=24,
    )
    torch.manual_seed(seed)
    return transformers.CLIPModel(hf_cfg).eval()


def _siglip_hf(seed=0):
    hf_cfg = transformers.SiglipConfig(
        text_config={"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
                     "intermediate_size": 64, "vocab_size": 99, "max_position_embeddings": 16},
        vision_config={"hidden_size": 48, "num_hidden_layers": 1, "num_attention_heads": 4,
                       "intermediate_size": 96, "image_size": 32, "patch_size": 8},
    )
    torch.manual_seed(seed)
    return transformers.SiglipModel(hf_cfg).eval()


@pytest.fixture(scope="module")
def clip_tree():
    hf = _clip_hf()
    cfg = tconv.clip_config_from_hf(hf.config)
    return hf, cfg, tconv.clip_params_from_hf(hf.state_dict(), cfg)


def _pixels(seed=0, size=32):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _port_embeddings(tree, cfg):
    model = zoo.dual_encoder_from_params(tree, cfg, device="cpu")
    ids = np.random.default_rng(1).integers(3, 98, size=(3, 16))
    with torch.no_grad():
        return (model.encode_image(torch.from_numpy(_pixels())).numpy(),
                model.encode_text(torch.from_numpy(ids)).numpy())


def _jax_embeddings(params, cfg):
    ids = np.random.default_rng(1).integers(3, 98, size=(3, 16))
    return (np.asarray(jax_encode_image(params, cfg, jnp.asarray(_pixels()))),
            np.asarray(jax_encode_text(params, cfg, jnp.asarray(ids))))


def test_native_roundtrip(clip_tree, tmp_path):
    _, cfg, tree = clip_tree
    path = tmp_path / "sub" / "clip.npz"
    tckpt.save_params(path, tree, cfg)
    tree2, cfg2 = tckpt.load_params(path)
    assert cfg2 == cfg
    assert_same_tree(tree2, tree)
    for a, b in zip(_port_embeddings(tree, cfg), _port_embeddings(tree2, cfg2)):
        np.testing.assert_array_equal(a, b)


def test_jax_written_cache_loads_in_the_port(clip_tree, tmp_path):
    hf, _, _ = clip_tree
    jcfg = jconv.clip_config_from_hf(hf.config)
    jparams = jconv.clip_params_from_hf(hf.state_dict(), jcfg)
    jckpt.save_params(tmp_path / "clip.npz", jparams, jcfg)
    tree, cfg = tckpt.load_params(tmp_path / "clip.npz")
    assert type(cfg).__module__.startswith("multimodal_embedding_tpu_torch.")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_same_tree(tree, jparams)
    for got, want in zip(_port_embeddings(tree, cfg), _jax_embeddings(jparams, jcfg)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_written_cache_loads_in_jax(clip_tree, tmp_path):
    hf, cfg, tree = clip_tree
    tckpt.save_params(tmp_path / "clip.npz", tree, cfg)
    jparams, jcfg = jckpt.load_params(tmp_path / "clip.npz")
    assert jcfg == jconv.clip_config_from_hf(hf.config)
    assert_same_tree(tree, jparams)
    direct = jconv.clip_params_from_hf(hf.state_dict(), jcfg)
    for got, want in zip(_jax_embeddings(jparams, jcfg), _jax_embeddings(direct, jcfg)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_port_embeddings(tree, cfg), _jax_embeddings(jparams, jcfg)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_colpali_and_jina_configs_roundtrip(tmp_path):
    from multimodal_embedding_tpu_torch.models.arch import full_colpali_config, full_jina_config

    for i, cfg in enumerate((full_colpali_config(), full_jina_config())):
        tckpt.save_params(tmp_path / f"{i}.npz", {"x": np.zeros(2, np.float32)}, cfg)
        assert tckpt.load_params(tmp_path / f"{i}.npz")[1] == cfg


def test_unported_config_type_is_named(tmp_path):
    from multimodal_embedding_tpu.models.qwen3 import QWEN3_14B

    jckpt.save_params(tmp_path / "qwen.npz", {"x": np.zeros(2, np.float32)}, QWEN3_14B)
    with pytest.raises(ValueError, match="Qwen3Config"):
        tckpt.load_params(tmp_path / "qwen.npz")


LOADERS = [("OpenAI-CLIP-L", "CLIPModel", _clip_hf), ("SigLIP-400M", "SiglipModel", _siglip_hf)]


@pytest.mark.parametrize("name,hf_class,build", LOADERS, ids=[n for n, *_ in LOADERS])
def test_load_model_native_cache(name, hf_class, build, tmp_path, monkeypatch):
    """The first load converts the checkpoint and writes the f32 cache; the
    second reads only the cache."""
    hub_offline(monkeypatch)
    monkeypatch.setattr(zoo, "hf_tokenizer", lambda info: zoo.hash_tokenizer(99, 16, 98))
    local = tmp_path / "hf_ckpt"
    hf = build(seed=5)
    hf.save_pretrained(local)
    info, cache = model_info(name), tmp_path / "native"
    m1 = zoo.load_model(info, device="cpu", dtype=torch.float32, checkpoint_dir=str(local),
                        native_cache_dir=str(cache))
    assert m1.weights_provenance == "real" and (cache / f"{name}.npz").exists()
    tree, _ = tckpt.load_params(cache / f"{name}.npz")
    assert {a.dtype for a in flat_tree(tree).values()} == {np.dtype(np.float32)}

    monkeypatch.setattr(transformers, hf_class, None)
    m2 = zoo.load_model(info, device="cpu", dtype=torch.float32, native_cache_dir=str(cache))
    assert m2.cfg == m1.cfg
    px = torch.from_numpy(_pixels(2))
    with torch.no_grad():
        torch.testing.assert_close(m2.model.encode_image(px), m1.model.encode_image(px), rtol=0, atol=0)
        ref = hf.get_image_features(pixel_values=px.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(m2.model.encode_image(px).detach().numpy(), ref, rtol=1e-4, atol=1e-4)
    # the cast is the loader's dtype; the cache stays f32
    m3 = zoo.load_model(info, device="cpu", dtype=torch.bfloat16, native_cache_dir=str(cache))
    assert m3.model.vision.patch["w"].dtype == torch.bfloat16


def test_load_model_dispatches_jina(monkeypatch):
    """``load_model`` sends Jina-CLIP-v1 to ``load_jina``, which converts
    the remote-code model's state dict strictly (here the reference model)."""
    from tests.jina_torch_reference import Eva02Torch, JinaBertTorch, JinaClipTorch

    hub_offline(monkeypatch)
    torch.manual_seed(0)
    ref = JinaClipTorch(Eva02Torch(image_size=32, patch_size=16, dim=128, layers=1, heads=2, mlp_dim=160,
                                   proj_dim=64),
                        JinaBertTorch(vocab=128, dim=128, layers=1, heads=2, mlp_dim=192)).eval()

    def tok(texts, **kw):
        ids = np.array([[1 + (len(t) + j) % 120 for j in range(6)] for t in texts])
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    seen = {}
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        lambda src, **kw: seen.setdefault("src", (src, kw)) and ref)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda src, **kw: tok)
    loaded = zoo.load_model(model_info("Jina-CLIP-v1"), device="cpu", dtype=torch.float32, checkpoint_dir="ckpt")
    assert seen["src"][0] == "ckpt" and seen["src"][1]["trust_remote_code"]
    assert loaded.model.vision.proj_b is not None
    ids, mask = loaded.tokenize(["a cat", "two dogs"])
    px = _pixels(3)
    with torch.no_grad():
        np.testing.assert_allclose(loaded.model.encode_image(torch.from_numpy(px)).numpy(),
                                   ref.encode_image(torch.from_numpy(px).permute(0, 3, 1, 2)).numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(loaded.model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
                                   ref.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_cli_real_checkpoint_path(tmp_path, monkeypatch):
    """``--native-cache-dir`` with neither debug flag: OpenAI-CLIP-L's
    converted weights come from the cache (a 336 px tower, as the registry's
    preprocessing gives); SigLIP-400M's load fails (here its checkpoint
    read), is logged, and the model is skipped."""
    hub_offline(monkeypatch)
    monkeypatch.setattr(zoo, "hf_tokenizer", lambda info: zoo.hash_tokenizer(99, 16, 98))
    load = tcli.load_model

    def load_or_fail(info, **kw):
        if info.name == "SigLIP-400M":
            raise OSError("SigLIP-400M: no checkpoint in the local HF cache")
        return load(info, **kw)

    monkeypatch.setattr(tcli, "load_model", load_or_fail)
    hf = _clip_hf(image_size=336, patch_size=48, seed=7)
    cfg = tconv.clip_config_from_hf(hf.config)
    cache = tmp_path / "native"
    tckpt.save_params(cache / "OpenAI-CLIP-L.npz", tconv.clip_params_from_hf(hf.state_dict(), cfg), cfg)
    out = tmp_path / "real.csv"
    rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--models", "OpenAI-CLIP-L,SigLIP-400M",
                    "--native-cache-dir", str(cache), "--sample-size", "16", "--bootstrap-iterations", "8",
                    "--batch-size", "8", "--output", str(out)])
    assert rc == 0
    df = pd.read_csv(out)
    assert list(df["Model"]) == ["OpenAI-CLIP-L"]
    assert df["Weights"][0] == "real"
    assert np.isfinite(df["T2I_R@1_mean"][0]) and float(df["QPS"][0]) > 0
