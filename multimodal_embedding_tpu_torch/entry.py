"""The two entry points of ``__graft_entry__.py``'s contract, on one NVIDIA GPU.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` -> ``(fn, example_args)``: the forward step on the flagship
  model, OpenAI-CLIP-L at its full architecture (random weights from seed 0,
  bf16): the preprocess kernel, the ViT-L image tower, L2 normalization;
- :func:`dryrun_multichip` (``dryrun.py``): one step of every parallel path
  over a world of ranks, on tiny shapes.

    python -c "from multimodal_embedding_tpu_torch.entry import entry; fn, a = entry(); print(fn(*a).shape)"
"""

from __future__ import annotations

import numpy as np

from .dryrun import dryrun_multichip  # noqa: F401  (the contract's other half)

IMAGE_H, IMAGE_W = 480, 640


def _flagship(dtype, *, tiny: bool = False, device):
    """OpenAI-CLIP-L as a ``LoadedModel`` on ``device`` in ``dtype``: the full
    architecture, or with ``tiny`` the debug dense config and its exact
    resize; weights from seed 0 and the hash tokenizer, as the JAX function."""
    from .models.arch import load_arch_model
    from .models.registry import model_info
    from .models.towers import DualEncoder
    from .models.zoo import LoadedModel, debug_dual_config, debug_preprocess, hash_tokenizer

    info = model_info("OpenAI-CLIP-L")
    if tiny:
        cfg = debug_dual_config("dense")
        model, pre = DualEncoder(cfg, seed=0, device=device, dtype=dtype), debug_preprocess(cfg)
    else:
        loaded = load_arch_model(info.name, seed=0, device=device, dtype=dtype)
        cfg, model, pre = loaded.cfg, loaded.model, info.preprocess
    return LoadedModel(info=info, cfg=cfg, model=model, preprocess=pre,
                       tokenize=hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, cfg.text.eos_token_id))


def entry(*, device="cuda"):
    """``(fn, (model, images))``: ``fn(model, images)`` is the forward step,
    preprocess -> ViT-L image encode -> L2 normalize, under
    ``torch.inference_mode``, returning ``[8, proj_dim]`` f32 embeddings
    (the bf16 tower projects in f32, as JAX's does). On a CUDA device the
    preprocess is its kernel (one launch a call) and every tower
    self-attention the attention kernel (one launch a layer) under the
    default attention impl; on the CPU both are their plain versions.

    ``images`` are the JAX example's 8 seeded uint8 images
    (``np.random.default_rng(0)``, 480x640), handed over as an NCHW tensor
    ``[8, 3, 480, 640]`` already on ``device``, where JAX hands NHWC numpy:
    NCHW is the preprocess kernel's layout and the one the port's engine
    stages. ``model`` is the ``DualEncoder`` module, the counterpart of the
    JAX params. Without a CUDA device this raises unless ``device="cpu"``."""
    import torch

    from .models.layers import l2_normalize
    from .ops.preprocess_cuda import make_preprocess_cuda_fn

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    flagship = _flagship(torch.bfloat16, device=device)
    pre = make_preprocess_cuda_fn(flagship.preprocess, IMAGE_H, IMAGE_W, device=device)

    def forward(model, images_u8):
        with torch.inference_mode():
            return l2_normalize(model.encode_image(pre(images_u8)))

    nhwc = np.random.default_rng(0).integers(0, 256, (8, IMAGE_H, IMAGE_W, 3), dtype=np.uint8)
    images = torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous().to(device)
    return forward, (flagship.model, images)
