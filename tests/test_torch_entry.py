"""The port's ``entry()`` against ``__graft_entry__.entry()``, on the CPU.

Both entry points build their flagship through ``_flagship``, patched here
to the tiny flagship (the debug dense config and its exact resize) in f32:
the JAX one as it is, the port's with the JAX-drawn weights carried by
``params_from_jax``. The example images are the same draw (NCHW in the
port), and the forward steps' L2-normalized embeddings agree to 1e-4 (f32
sums in another order, as ``tests/test_torch_slice.py``).

Also here: ``entry()`` needs a card unless asked for the CPU, the port's
module carries the contract's other half, and the launch counts split the
f32 bodies of attention and MaxSim from the bf16 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from multimodal_embedding_tpu_torch import dryrun, entry as tentry, ops
from multimodal_embedding_tpu_torch.models.zoo import dual_encoder_from_params
from multimodal_embedding_tpu_torch.ops import attention_cuda
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX ``entry()`` on the tiny flagship in f32: (params, images,
    embeddings)."""
    orig = jentry._flagship
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jentry, "_flagship", lambda dtype: orig(jnp.float32, tiny=True))
        forward, (params, images) = jentry.entry()
    return params, images, np.asarray(forward(params, images))


def test_entry_matches_jax(jax_step, monkeypatch):
    params, images, want = jax_step
    orig = tentry._flagship

    def flagship(dtype, *, tiny=False, device):
        loaded = orig(torch.float32, tiny=True, device=device)
        loaded.model = dual_encoder_from_params(jax.tree.map(np.asarray, params), loaded.cfg, device=device)
        return loaded

    monkeypatch.setattr(tentry, "_flagship", flagship)
    fn, (model, timages) = tentry.entry(device="cpu")
    assert timages.dtype == torch.uint8 and timages.device.type == "cpu"
    np.testing.assert_array_equal(timages.numpy(), np.asarray(images).transpose(0, 3, 1, 2))
    got = fn(model, timages)
    assert got.shape == want.shape == (8, model.cfg.vision.proj_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()


def test_entry_carries_the_dryrun():
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def test_launch_counts_put_each_launch_under_one_name(monkeypatch):
    """The attention wrapper counts a launch under its body's name (the
    kernel call itself replaced: no card here), a bf16 one at Dh <= 80 also
    as ``fused_attention_wgmma``; the other wrappers' counts reach
    ``launch_counts`` under their own keys, the prologue's row pass too."""
    monkeypatch.setattr(KERNELS, "counts", {})
    monkeypatch.setattr(attention_cuda, "_run", lambda q, *args: q)
    for dtype, n in ((torch.bfloat16, 4), (torch.float32, 3)):
        x = torch.zeros(1, 2, 3, 8, dtype=dtype)
        for _ in range(n):
            attention_cuda._launch(x, x, x, None, False, 1.0, "bhtd", 2, 2)
    for _ in range(2):
        attention_cuda._launch_qkv(torch.zeros(1, 3, 48, dtype=torch.bfloat16), None, True, 1.0, 2, 2)
    for name, n in (("maxsim", 4), ("maxsim_f32", 1), ("preprocess", 4), ("fused_res_norm_matmul", 6),
                    ("fused_layer_norm", 8), ("fused_res_norm_rows", 5), ("mlp_activation", 7), ("grouped_mm", 9),
                    ("moe_swiglu", 10), ("moe_combine", 11), ("ssm_scan", 12),
                    ("ssm_scan_chunked", 3), ("kda_scan", 13)):
        KERNELS.count(name, n)
    counts = ops.launch_counts()
    assert counts == {"fused_attention": 4, "fused_attention_f32": 3, "fused_attention_qkv": 2, "preprocess": 4,
                      "maxsim": 4, "maxsim_f32": 1, "fused_res_norm_matmul": 6, "fused_layer_norm": 8,
                      "fused_res_norm_rows": 5, "mlp_activation": 7, "grouped_mm": 9,
                      "fused_attention_wgmma": 6, "moe_swiglu": 10, "moe_combine": 11, "ssm_scan": 12,
                      "ssm_scan_chunked": 3, "kda_scan": 13}
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
