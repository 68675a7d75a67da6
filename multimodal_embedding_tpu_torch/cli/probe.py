"""Model setup verification probe (reference A28: test_siglip_debug.py,
test_siglip_coco_sample.py, run_benchmark_openai_apple_only.py's setup check).

Counterpart of ``multimodal_embedding_tpu/cli/probe.py``. For each requested
model: load it (real, arch or debug weights), encode a test image and two
captions, and report embedding shapes, norms (about 1.0 after L2), mean and
std, the caption-image similarities and a sanity verdict (similarity > 0.2
passes with real weights, test_siglip_debug.py:52-55). Exits nonzero on a
failure. ``--hf-parity`` (real weights) also runs the HF reference on the
same fixture and requires per-row cosine >= ``--parity-threshold``; it
imports transformers, and only then. Runs on ``--device`` (default cuda;
without a CUDA device it exits nonzero unless ``--device cpu`` was given).

    python -m multimodal_embedding_tpu_torch.cli.probe --models OpenAI-CLIP-L --weights arch
"""

from __future__ import annotations

import argparse
import contextlib
import io

import numpy as np
import torch

from ..models.encode import EncodingEngine
from ..models.registry import get_models_to_test, model_info
from ..parallel.mesh import distributed, is_writer
from ..retrieval.scoring import late_interaction_scores
from ..utils.logging import setup_logging
from .main import data_mesh, device_arg, load_model_for


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Model setup verification probe")
    p.add_argument("--models", default="all")
    p.add_argument("--weights", choices=["real", "arch", "debug"], default="real")
    p.add_argument("--sim-threshold", type=float, default=0.2,
                   help="pos-pair cosine must exceed this (real weights only)")
    p.add_argument("--hf-parity", action="store_true",
                   help="also run the HF torch reference on the same fixture "
                        "and require per-row embedding cosine >= "
                        "--parity-threshold (needs transformers)")
    p.add_argument("--parity-threshold", type=float, default=0.999)
    p.add_argument("--checkpoint-dir", default=None,
                   help="local checkpoint directory override (instead of the "
                        "HF hub id) for both our loader and the HF reference")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun), cuda:N or, only when asked, cpu")
    return p.parse_args(argv)


def _cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _checkpoint_state_dict(src):
    """Raw torch state dict from a checkpoint directory (safetensors or
    .bin shards), else transformers remote-code loading: lets the Jina gate
    run without executing the checkpoint's modeling code."""
    from pathlib import Path

    p = Path(src)
    if p.is_dir():
        shards = sorted(p.glob("*.safetensors"))
        if shards:
            from safetensors.torch import load_file

            sd = {}
            for f in shards:
                sd.update(load_file(f))
            return sd
        shards = sorted(p.glob("pytorch_model*.bin"))
        if shards:
            sd = {}
            for f in shards:
                sd.update(torch.load(f, map_location="cpu", weights_only=True))
            return sd
    from transformers import AutoModel

    return AutoModel.from_pretrained(src, trust_remote_code=True).state_dict()


def _report(ci: np.ndarray, ct: np.ndarray, threshold: float, label: str = "") -> bool:
    print(f"  hf-parity cosine{label}: image {ci.min():.6f}, text {ct.min():.6f}")
    if min(ci.min(), ct.min()) < threshold:
        print(f"  ❌ hf-parity below {threshold}")
        return False
    return True


def _colpali_parity(model, src: str, threshold: float) -> bool:
    """ColPali gate via transformers' ColPaliForRetrieval."""
    from transformers import ColPaliForRetrieval

    hf = ColPaliForRetrieval.from_pretrained(src, torch_dtype=torch.float32).eval()
    cfg, net = model.cfg, model.model
    dev = net.image_suffix_ids.device
    rng = np.random.default_rng(0)

    size = cfg.vision.image_size
    n_patches = (size // cfg.vision.patch_size) ** 2
    suffix = net.image_suffix_ids.cpu().numpy().astype(np.int64)
    pixels = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    ids_img = np.concatenate([np.full((1, n_patches), cfg.image_token_id, np.int64), suffix[None]], axis=1)
    ids = rng.integers(3, cfg.gemma.vocab_size - 3, size=(2, 16)).astype(np.int64)
    mask = np.ones((2, 16), np.int64)
    mask[0, :5] = 0  # processor-style left padding
    ids[0, :5] = 0
    with torch.inference_mode():
        ref_img = hf(input_ids=torch.from_numpy(ids_img), attention_mask=torch.ones_like(torch.from_numpy(ids_img)),
                     pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).embeddings.numpy()
        ref_txt = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).embeddings.numpy()
        ours_img = _np(net.image_fwd(torch.from_numpy(pixels).to(dev)))
        ours_txt = _np(net.text_fwd(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)))
    del hf
    return _report(_cosine_rows(ours_img, ref_img), _cosine_rows(ours_txt, ref_txt), threshold, " (multi-vector)")


def _jina_parity(model, src: str, threshold: float) -> bool:
    """Jina gate via the independent torch reference
    (tests/jina_torch_reference.py, the checkpoint's key schema) loaded with
    the checkpoint's weights, without running its remote modeling code."""
    try:
        from tests.jina_torch_reference import Eva02Torch, JinaBertTorch, JinaClipTorch
    except ImportError:
        print("  (hf-parity: tests/jina_torch_reference.py not importable from "
              "this install; jina gate needs the repo checkout — skipped)")
        return True

    from ..models.jina import jina_config_from_sd

    sd = _checkpoint_state_dict(src)
    cfg = jina_config_from_sd(sd)
    v, t = cfg.vision, cfg.text
    vision = Eva02Torch(
        image_size=v.image_size, patch_size=v.patch_size, dim=v.dim, layers=v.layers,
        heads=v.heads, mlp_dim=v.mlp_dim, proj_dim=v.proj_dim, eps=v.ln_eps,
        rope_theta=v.rope_theta, rope_pt_grid=v.rope_pt_grid,
    )
    bert = JinaBertTorch(t.vocab_size, t.dim, t.layers, t.heads, t.mlp_dim)
    ref = JinaClipTorch(vision, bert).eval()
    missing, unexpected = ref.load_state_dict(sd, strict=False)
    # proj bias exists in the real checkpoint but is optional in the torch ref
    real_missing = [k for k in missing if k != "vision.proj_b"]
    if real_missing or unexpected:
        print(f"  ❌ hf-parity: torch reference/state-dict key drift: "
              f"missing={real_missing[:4]} unexpected={list(unexpected)[:4]}")
        return False

    rng = np.random.default_rng(0)
    dev = next(model.model.parameters()).device
    pixels = rng.standard_normal((2, v.image_size, v.image_size, 3)).astype(np.float32)
    ids = rng.integers(3, t.vocab_size - 3, size=(2, 48)).astype(np.int64)
    mask = np.ones((2, 48), np.int64)
    mask[1, 32:] = 0
    with torch.inference_mode():
        ref_img = ref.encode_image(torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
        ref_txt = ref.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ours_img = _np(model.model.encode_image(torch.from_numpy(pixels).to(dev)))
        ours_txt = _np(model.model.encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)))
    del ref
    return _report(_cosine_rows(ours_img, ref_img), _cosine_rows(ours_txt, ref_txt), threshold)


def hf_parity_check(model, info, checkpoint_dir: str | None = None, threshold: float = 0.999) -> bool:
    """Run the HF torch reference on the same pixel/token fixture and require
    per-row cosine >= threshold for image and text embeddings: dense and
    siglip through CLIPModel/SiglipModel get_*_features, ColPali through
    ColPaliForRetrieval, Jina through the independent torch reference."""
    src = checkpoint_dir or info.hf_id
    try:
        if info.type == "colpali":
            return _colpali_parity(model, src, threshold)
        if info.type == "jina":
            return _jina_parity(model, src, threshold)
    except Exception as e:  # a failed reference fails the gate, with the reason
        print(f"  ❌ hf-parity: {info.type} reference failed: {e}")
        return False
    try:
        from transformers import CLIPModel, SiglipModel

        cls = SiglipModel if info.type == "siglip" else CLIPModel
        hf = cls.from_pretrained(src, torch_dtype=torch.float32, trust_remote_code=info.trust_remote_code).eval()
    except Exception as e:  # a failed reference load fails the gate, with the reason
        print(f"  ❌ hf-parity: reference load failed: {e}")
        return False

    rng = np.random.default_rng(0)
    net = model.model
    dev = next(net.parameters()).device
    size = model.cfg.vision.image_size
    pixels = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    tcfg = model.cfg.text
    ids = rng.integers(3, tcfg.vocab_size - 3, size=(2, tcfg.max_len))
    if info.type == "dense":  # CLIP pools at BOS/EOS positions
        ids[:, 0] = tcfg.vocab_size - 2
        ids[:, -1] = tcfg.vocab_size - 1
    with torch.inference_mode():
        ref_img = hf.get_image_features(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
        ref_txt = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
        ours_img = _np(net.encode_image(torch.from_numpy(pixels).to(dev)))
        ours_txt = _np(net.encode_text(torch.from_numpy(ids).to(dev)))
    del hf
    return _report(_cosine_rows(ours_img, ref_img), _cosine_rows(ours_txt, ref_txt), threshold)


def probe_model(name: str, weights: str, threshold: float, hf_parity: bool = False, parity_threshold: float = 0.999,
                checkpoint_dir: str | None = None, *, device) -> bool:
    info = model_info(name)
    try:
        model = load_model_for(info, debug=weights == "debug", arch=weights == "arch", seed=0, device=device,
                               checkpoint_dir=checkpoint_dir)
    except Exception as e:  # the probe reports a failed load and goes on to the next model
        print(f"  ❌ load failed: {e}")
        return False

    if hf_parity and weights == "real":
        if not hf_parity_check(model, info, checkpoint_dir, parity_threshold):
            return False

    engine = EncodingEngine(model, 4, device=device, mesh=data_mesh())
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // w), (yy * 255 // h), np.full((h, w), 128)], -1).astype(np.uint8)
    texts = ["a colorful gradient test pattern", "a photo of a dog in the park"]

    ie = engine.encode_images([img]).embeddings
    te = engine.encode_texts(texts).embeddings

    def stats(x, label):
        flat = _np(x).reshape(-1, x.shape[-1])
        norms = np.linalg.norm(flat, axis=-1)
        nz = norms[norms > 1e-6]
        print(f"  {label}: shape {tuple(x.shape)}, norm {nz.mean():.4f}, "
              f"mean {flat.mean():+.4f}, std {flat.std():.4f}")
        return nz

    i_norms = stats(ie, "image emb")
    t_norms = stats(te, "text emb ")
    ok = bool(np.allclose(i_norms, 1.0, atol=1e-2) and np.allclose(t_norms, 1.0, atol=1e-2))
    if not ok:
        print("  ❌ embeddings not unit-norm")
        return False

    if model.multi_vector:
        sims = _np(late_interaction_scores(te, ie))[:, 0]
        print(f"  maxsim scores: {sims}")
    else:
        sims = (_np(te) @ _np(ie).T)[:, 0]
        print(f"  cosine sims: {sims}")
        if weights == "real" and sims.max() <= threshold:
            print(f"  ❌ max sim {sims.max():.3f} <= {threshold} (weak embeddings)")
            return False
    print("  ✅ PASS")
    return True


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging(None)
    ok = True
    with distributed(args.device) as device:
        # every rank probes (each encodes its rows); rank 0 prints
        quiet = contextlib.nullcontext() if is_writer() else contextlib.redirect_stdout(io.StringIO())
        with quiet:
            for info in get_models_to_test(args.models, 4):
                print(f"=== {info.name} ({info.hf_id}) ===")
                ok &= probe_model(info.name, args.weights, args.sim_threshold, hf_parity=args.hf_parity,
                                  parity_threshold=args.parity_threshold, checkpoint_dir=args.checkpoint_dir,
                                  device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
