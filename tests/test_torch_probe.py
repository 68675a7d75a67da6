"""The port's probe CLI, on the CPU.

- ``--weights debug`` passes for a dense and the multi-vector model, as the
  JAX package's probe does (``tests/test_report_and_v28.py``).
- ``hf_parity_check``, the gate behind ``--hf-parity``, on small random-weight
  HF models saved into ``tmp_path`` (``CLIPModel``, ``ColPaliForRetrieval``),
  converted by the port's converters and loaded into its modules, with the
  hub forced offline (``tests/test_torch_convert.py:hub_offline``): per-row
  cosine against the HF model >= 0.999 passes, and corrupted weights fail,
  as ``tests/test_probe_parity.py`` holds the JAX gate.
"""

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu_torch.cli import probe
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.models.zoo import LoadedModel, dual_encoder_from_params, hash_tokenizer
from tests.test_torch_convert import hub_offline
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_probe_debug_models_pass():
    assert probe.main(["--models", "OpenAI-CLIP-L,ColPali-v1.3", "--weights", "debug", "--device", "cpu"]) == 0


def test_probe_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main(["--models", "OpenAI-CLIP-L", "--weights", "debug"])
    assert exc.value.code not in (0, None)


@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory):
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                     "vocab_size": 96, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
                     "eos_token_id": 95, "bos_token_id": 94},
        vision_config={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                       "image_size": 32, "patch_size": 16, "hidden_act": "quick_gelu"},
        projection_dim=24,
    )
    torch.manual_seed(0)
    hf = CLIPModel(cfg).eval()
    d = tmp_path_factory.mktemp("clip_ckpt")
    hf.save_pretrained(d)
    return d, hf


def _port_clip(hf, corrupt: bool = False):
    from multimodal_embedding_tpu_torch.models.convert import clip_config_from_hf, clip_params_from_hf

    cfg = clip_config_from_hf(hf.config)
    tree = clip_params_from_hf(hf.state_dict(), cfg)
    if corrupt:  # one projection replaced: the gate must fail loudly
        tree["vision"]["proj"] = np.full_like(tree["vision"]["proj"], 0.3)
    info = model_info("OpenAI-CLIP-L")
    model = LoadedModel(info=info, cfg=cfg, model=dual_encoder_from_params(tree, cfg, device="cpu"),
                        preprocess=info.preprocess, tokenize=hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, 95))
    return model, info


@pytest.mark.parametrize("corrupt", [False, True])
def test_hf_parity_gate_on_clip(clip_checkpoint, monkeypatch, corrupt):
    hub_offline(monkeypatch)
    ckpt, hf = clip_checkpoint
    model, info = _port_clip(hf, corrupt)
    assert probe.hf_parity_check(model, info, checkpoint_dir=str(ckpt), threshold=0.999) is not corrupt


@pytest.fixture(scope="module")
def colpali_checkpoint(tmp_path_factory):
    from transformers import ColPaliConfig as HFColPaliConfig
    from transformers import ColPaliForRetrieval, PaliGemmaConfig

    vlm = PaliGemmaConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                           image_size=32, patch_size=16, projection_dim=48),
        text_config=dict(model_type="gemma", hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=1, head_dim=12, intermediate_size=96, vocab_size=300,
                         rope_theta=10000.0),
        image_token_index=280,
        projection_dim=48,
    )
    torch.manual_seed(1)
    hf = ColPaliForRetrieval(HFColPaliConfig(vlm_config=vlm, embedding_dim=16)).eval()
    d = tmp_path_factory.mktemp("colpali_ckpt")
    hf.save_pretrained(d)
    return d, hf


@pytest.mark.parametrize("corrupt", [False, True])
def test_hf_parity_gate_on_colpali(colpali_checkpoint, monkeypatch, corrupt):
    from multimodal_embedding_tpu_torch.models.colpali import (
        colpali_config_from_hf,
        colpali_from_params,
        colpali_params_from_hf,
    )

    hub_offline(monkeypatch)
    ckpt, hf = colpali_checkpoint
    cfg = colpali_config_from_hf(hf.config)
    tree = colpali_params_from_hf(hf.state_dict(), cfg, np.array([2, 17, 18, 19], np.int32))
    if corrupt:
        tree["emb_proj"]["w"] = np.full_like(tree["emb_proj"]["w"], 0.1)
    info = model_info("ColPali-v1.3")
    model = LoadedModel(info=info, cfg=cfg, model=colpali_from_params(tree, cfg, device="cpu"),
                        preprocess=info.preprocess, tokenize=hash_tokenizer(cfg.gemma.vocab_size, 16, 1),
                        multi_vector=True)
    assert probe.hf_parity_check(model, info, checkpoint_dir=str(ckpt), threshold=0.999) is not corrupt
