"""The port's ColPali conversion, loading and prompt processing on the CPU.

- A random-weight HF ``ColPaliForRetrieval`` built from a small config (no
  network): the port's converter gives the JAX converter's config and param
  tree (tolerance 0), and the converted port model matches HF in f32 on
  images, right-padded queries and left-padded queries (rtol and atol 1e-4).
- ``models/colpali_processing.py``: token ids equal those of a
  ``ColPaliProcessor`` built here around an offline-trained Gemma BPE
  tokenizer, and string -> ids -> port model equals string -> HF processor
  -> HF model.
- ``load_colpali`` from a ``save_pretrained`` directory, offline, and
  ``zoo.hf_tokenizer`` on that tokenizer against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import colpali as jcolpali
from multimodal_embedding_tpu.models import colpali_processing as jproc
from multimodal_embedding_tpu_torch.models import colpali as tcolpali
from multimodal_embedding_tpu_torch.models.colpali_processing import (
    ColPaliPrompts,
    colpali_query_tokenizer,
    image_input_ids,
    image_prompt_suffix_ids,
    process_queries_ids,
    prompts_from_processor,
)
from tests.test_torch_convert import assert_same_tree, hub_offline

RTOL = ATOL = 1e-4
SUFFIX_IDS = np.array([1, 7, 8, 9], np.int32)
IMAGE_SEQ_LEN = 4  # (28 / 14)^2 patches


def _hf_colpali(vocab_size: int, image_token_id: int, seed: int):
    from transformers import ColPaliConfig as HFColPaliConfig
    from transformers import ColPaliForRetrieval, PaliGemmaConfig

    vlm = PaliGemmaConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=64, image_size=28, patch_size=14, projection_dim=48),
        text_config=dict(model_type="gemma", hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=1, head_dim=16, intermediate_size=96, vocab_size=vocab_size,
                         rope_theta=10000.0),
        image_token_index=image_token_id,
        projection_dim=48,
    )
    torch.manual_seed(seed)
    return ColPaliForRetrieval(HFColPaliConfig(vlm_config=vlm, embedding_dim=16)).eval()


@pytest.fixture(scope="module")
def colpali_pair():
    hf = _hf_colpali(512, 500, seed=0)
    cfg = tcolpali.colpali_config_from_hf(hf.config)
    tree = tcolpali.colpali_params_from_hf(hf.state_dict(), cfg, SUFFIX_IDS)
    return hf, cfg, tree, tcolpali.colpali_from_params(tree, cfg, device="cpu")


def test_converter_matches_jax(colpali_pair):
    hf, cfg, tree, _ = colpali_pair
    jcfg = jcolpali.colpali_config_from_hf(hf.config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tree["image_suffix_ids"].dtype == np.int32
    assert_same_tree(tree, jcolpali.colpali_params_from_hf(hf.state_dict(), jcfg, SUFFIX_IDS))


def test_image_matches_hf(colpali_pair):
    hf, _, _, model = colpali_pair
    b = 2
    pixels = np.random.default_rng(0).standard_normal((b, 28, 28, 3)).astype(np.float32)
    ids = np.concatenate([np.full((b, IMAGE_SEQ_LEN), 500, np.int64), np.tile(SUFFIX_IDS, (b, 1))], axis=1)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.ones(ids.shape, dtype=torch.long),
                 pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).embeddings.numpy()
        ours = model.image_fwd(torch.from_numpy(pixels)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("padding", ["right", "left"])
def test_query_matches_hf(colpali_pair, padding):
    """ColPaliProcessor left-pads query batches: positions follow the mask."""
    hf, _, _, model = colpali_pair
    ids = np.random.default_rng(1).integers(2, 499, size=(3, 10)).astype(np.int64)
    mask = np.ones((3, 10), np.int64)
    pad = np.s_[1, 7:] if padding == "right" else np.s_[1, :3]
    mask[pad] = 0
    ids[pad] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).embeddings.numpy()
        ours = model.text_fwd(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    assert (ours[1][mask[1] == 0] == 0).all()


# --- prompt processing against transformers.ColPaliProcessor ------------------------

QUERIES = [
    "a photo of a cat",
    "two dogs playing with a red ball in the park on the beach",
    "zebra unseen words",  # byte-level fallback pieces
]


@pytest.fixture(scope="module")
def hf_processor():
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import GemmaTokenizerFast, SiglipImageProcessor
    from transformers.models.colpali.processing_colpali import ColPaliProcessor

    tk = Tokenizer(models.BPE(unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<pad>", "<eos>", "<bos>", "<unk>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["Describe the image.", "Query: a photo of a cat sitting on a mat",
              "a man riding a horse on the beach", "two dogs playing with a red ball in the park"]
    tk.train_from_iterator(corpus * 10, trainer)
    tok = GemmaTokenizerFast(tokenizer_object=tk, pad_token="<pad>", bos_token="<bos>", eos_token="<eos>",
                             unk_token="<unk>", padding_side="left")
    sip = SiglipImageProcessor(size={"height": 28, "width": 28}, image_seq_length=IMAGE_SEQ_LEN)
    return ColPaliProcessor(image_processor=sip, tokenizer=tok, query_prefix="Query: ")


def test_prompts_copy_matches_jax(hf_processor):
    prompts = prompts_from_processor(hf_processor)
    assert dataclasses.asdict(prompts) == dataclasses.asdict(jproc.prompts_from_processor(hf_processor))
    assert prompts == ColPaliPrompts()


def test_process_queries_token_parity(hf_processor):
    ref = hf_processor.process_queries(QUERIES, return_tensors="np")
    ids, mask = process_queries_ids(hf_processor.tokenizer, QUERIES, prompts_from_processor(hf_processor))
    np.testing.assert_array_equal(ids, ref["input_ids"].astype(np.int32))
    np.testing.assert_array_equal(mask, ref["attention_mask"].astype(np.int32))
    assert (mask[:, 0] == 0).any()  # left padding
    # the 10 augmentation pad tokens are attended; only batch padding is 0
    assert mask[0].sum() < mask[1].sum() and mask.max() == 1


def test_process_queries_long_query_parity(hf_processor):
    """ColPaliProcessor's nominal max_length=50 never truncates."""
    long_query = " ".join(["word unseen"] * 60)
    ref = hf_processor.process_queries([long_query], return_tensors="np")
    ids, _ = process_queries_ids(hf_processor.tokenizer, [long_query], prompts_from_processor(hf_processor))
    assert ids.shape[1] == ref["input_ids"].shape[1] > 50
    np.testing.assert_array_equal(ids, ref["input_ids"].astype(np.int32))


def test_process_images_token_parity(hf_processor):
    from PIL import Image

    rng = np.random.default_rng(2)
    imgs = [Image.fromarray(rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)) for _ in range(2)]
    ref = hf_processor.process_images(imgs, return_tensors="np")
    prompts = prompts_from_processor(hf_processor)
    ours = image_input_ids(hf_processor.tokenizer, hf_processor.image_token_id, IMAGE_SEQ_LEN, 2, prompts)
    np.testing.assert_array_equal(ours, ref["input_ids"].astype(np.int32))
    np.testing.assert_array_equal(ours[0, IMAGE_SEQ_LEN:], image_prompt_suffix_ids(hf_processor.tokenizer, prompts))
    assert ref["attention_mask"].min() == 1  # image prompts are unpadded


@pytest.fixture(scope="module")
def processor_pair(hf_processor):
    """An HF ColPali over the offline tokenizer's ids, with the processor's
    image token id and prompt suffix, and its converted port model."""
    hf = _hf_colpali(2048, hf_processor.image_token_id, seed=1)
    cfg = tcolpali.colpali_config_from_hf(hf.config)
    suffix = image_prompt_suffix_ids(hf_processor.tokenizer, prompts_from_processor(hf_processor))
    tree = tcolpali.colpali_params_from_hf(hf.state_dict(), cfg, suffix)
    return hf, tcolpali.colpali_from_params(tree, cfg, device="cpu")


def test_full_query_pipeline_matches_hf(hf_processor, processor_pair):
    """string -> the port's wrapping -> port model == string -> HF processor -> HF."""
    hf, model = processor_pair
    with torch.no_grad():
        ref = hf(**hf_processor.process_queries(QUERIES, return_tensors="pt")).embeddings.numpy()
        ids, mask = colpali_query_tokenizer(hf_processor.tokenizer, prompts_from_processor(hf_processor))(QUERIES)
        ours = model.text_fwd(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_full_image_pipeline_matches_hf(hf_processor, processor_pair):
    """image -> the port's preprocess + model == image -> HF processor -> HF."""
    from PIL import Image

    from multimodal_embedding_tpu_torch.ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, PreprocessConfig, make_preprocess_fn

    hf, model = processor_pair
    raw = [np.random.default_rng(3).integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(2)]
    batch = hf_processor.process_images([Image.fromarray(r) for r in raw], return_tensors="pt")
    pre = PreprocessConfig(image_size=28, resize_mode="exact", mean=SIGLIP_MEAN, std=SIGLIP_STD)
    with torch.no_grad():
        ref = hf(**batch).embeddings.numpy()
        pixels = make_preprocess_fn(pre, 28, 28, input_format="nhwc", device="cpu")(torch.from_numpy(np.stack(raw)))
        ours = model.image_fwd(pixels).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_load_colpali_from_a_local_checkpoint(hf_processor, processor_pair, tmp_path, monkeypatch):
    hub_offline(monkeypatch)
    from multimodal_embedding_tpu_torch.models.registry import model_info

    hf, model = processor_pair
    hf.save_pretrained(tmp_path)
    hf_processor.save_pretrained(tmp_path)
    loaded = tcolpali.load_colpali(model_info("ColPali-v1.3"), device="cpu", dtype=torch.float32,
                                   checkpoint_dir=str(tmp_path))
    assert loaded.multi_vector and loaded.weights_provenance == "real"
    ids, mask = loaded.tokenize(QUERIES)
    want_ids, want_mask = process_queries_ids(hf_processor.tokenizer, QUERIES)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    with torch.no_grad():
        got = loaded.model.text_fwd(torch.from_numpy(ids), torch.from_numpy(mask))
        want = model.text_fwd(torch.from_numpy(ids), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(loaded.model.image_suffix_ids, model.image_suffix_ids, rtol=0, atol=0)


def test_hf_tokenizer_matches_jax(hf_processor, tmp_path, monkeypatch):
    """Fixed-length padding to the registry's ``text_max_len``, truncation
    past it, the same ids and mask as the JAX package's ``hf_tokenizer``."""
    hub_offline(monkeypatch)
    from multimodal_embedding_tpu.models import registry as jregistry
    from multimodal_embedding_tpu.models import zoo as jzoo
    from multimodal_embedding_tpu_torch.models import registry, zoo

    hf_processor.tokenizer.save_pretrained(tmp_path)
    info = dataclasses.replace(registry.model_info("SigLIP-400M"), hf_id=str(tmp_path), text_max_len=12)
    jinfo = dataclasses.replace(jregistry.model_info("SigLIP-400M"), hf_id=str(tmp_path), text_max_len=12)
    ids, mask = zoo.hf_tokenizer(info)(QUERIES)
    want_ids, want_mask = jzoo.hf_tokenizer(jinfo)(QUERIES)
    assert ids.shape == mask.shape == (3, 12) and ids.dtype == mask.dtype == np.int32
    assert mask[0].sum() < 12 == mask[1].sum()  # padded, and truncated
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
