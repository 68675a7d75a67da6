"""The port's preprocessing against the JAX package's, on the CPU.

The weight matrices must be exactly equal (the port keeps a verbatim numpy
copy of the builders). The plain torch preprocess is held against JAX
``make_preprocess_fn`` on the four synthetic geometries: at least 99.9% of
the output elements bit-equal, and no element more than one quantization
level (1/255/std_c) apart, since a resize sum taken in another order can land
on the other side of a rounding boundary.

Against ``preprocess_pallas(interpret=True)`` the same holds for the uint8
levels before the final scale and shift. The f32 outputs are compared to a
few ulps there: in interpret mode on the CPU the JAX kernel's own output
differs from its XLA path in the last bit of about half the elements (its
scale-and-shift is rounded once, the XLA path's twice), so no port can be
bit-equal to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models.registry import model_info as jax_model_info
from multimodal_embedding_tpu.ops import preprocess as jpre
from multimodal_embedding_tpu.ops.preprocess_pallas import preprocess_pallas
from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config, debug_preprocess
from multimodal_embedding_tpu_torch.ops import preprocess as tpre
from multimodal_embedding_tpu_torch.ops.preprocess_cuda import make_preprocess_cuda_fn, preprocess_weights

GEOMETRIES = [(480, 640), (640, 480), (480, 480), (427, 640)]
CFG = tpre.PreprocessConfig(image_size=336)  # OpenAI-CLIP-L's recipe


def _as_jax_cfg(cfg: tpre.PreprocessConfig) -> jpre.PreprocessConfig:
    return jpre.PreprocessConfig(**cfg.__dict__)


def _images(h, w, b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, 3, h, w), dtype=np.uint8)


def test_registry_recipe_matches_jax():
    from multimodal_embedding_tpu_torch.models.registry import model_info

    assert model_info("OpenAI-CLIP-L").preprocess.__dict__ == jax_model_info("OpenAI-CLIP-L").preprocess.__dict__
    assert CFG.__dict__ == jax_model_info("OpenAI-CLIP-L").preprocess.__dict__


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("cfg", [CFG, debug_preprocess(debug_dual_config("dense"))], ids=["clip-l", "debug"])
def test_weights_exactly_equal(cfg, h, w):
    tv, th = tpre._cropped_weights(cfg, h, w)
    jv, jh = jpre._cropped_weights(_as_jax_cfg(cfg), h, w)
    assert np.array_equal(tv, jv) and np.array_equal(th, jh)
    assert np.array_equal(tpre.scale_shift(cfg)[0], (cfg.rescale / np.asarray(cfg.std, np.float32)).astype(np.float32))


def _check_close(got: np.ndarray, want: np.ndarray, cfg) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.mean(got == want) >= 0.999
    level = tpre.scale_shift(cfg)[0]
    for ch in range(3):
        assert np.abs(got[..., ch] - want[..., ch]).max() <= level[ch] * (1 + 1e-5) + 1e-6


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_plain_matches_jax_xla(h, w):
    x = _images(h, w)
    want = np.asarray(jpre.make_preprocess_fn(_as_jax_cfg(CFG), h, w, input_format="nchw")(jnp.asarray(x)))
    got = tpre.make_preprocess_fn(CFG, h, w, device="cpu", input_format="nchw")(torch.from_numpy(x)).numpy()
    _check_close(got, want, CFG)


def _levels(out: np.ndarray, cfg) -> np.ndarray:
    scale, shift = tpre.scale_shift(cfg)
    return np.round((out.astype(np.float64) - shift) / scale)


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_plain_matches_jax_pallas_interpret(h, w):
    x = _images(h, w, b=1, seed=1)
    want = np.asarray(preprocess_pallas(jnp.asarray(x), _as_jax_cfg(CFG), h, w, interpret=True))
    got = make_preprocess_cuda_fn(CFG, h, w, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    lg, lw = _levels(got, CFG), _levels(want, CFG)
    assert np.mean(lg == lw) >= 0.999 and np.abs(lg - lw).max() <= 1
    same = lg == lw
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=4 * np.spacing(np.float32(8.0)))


def test_nhwc_input_matches_nchw():
    h, w = 480, 640
    x = _images(h, w)
    a = tpre.make_preprocess_fn(CFG, h, w, device="cpu", input_format="nchw")(torch.from_numpy(x))
    b = tpre.make_preprocess_fn(CFG, h, w, device="cpu")(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    assert torch.equal(a, b)


def test_normalize_matches_jax():
    x = _images(336, 336)
    want = np.asarray(jpre.make_normalize_fn(_as_jax_cfg(CFG))(jnp.asarray(x)))
    got = tpre.make_normalize_fn(CFG, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _emulate_kernel(x: np.ndarray, wts) -> np.ndarray:
    """numpy replay of csrc/preprocess.cu's banded arithmetic (f32, each sum
    over its band in ascending order) for one [3, H, W] image."""
    f32 = np.float32
    whb, hband, wv, vband, tiles = (t.numpy() for t in (wts.whb, wts.hband, wts.wv, wts.vband, wts.tiles))
    c, r = wts.c, wts.rows_per_tile
    out = np.empty((c, c, 3), f32)
    cols = np.arange(c)
    for ch in range(3):
        img = x[ch].astype(f32)
        for t, (hlo, hhi) in enumerate(tiles):
            rows = img[hlo:hhi]  # [span, W]
            acc = np.zeros((hhi - hlo, c), f32)
            for k in range(whb.shape[1]):
                live = k < hband[:, 1] - hband[:, 0]
                src = np.minimum(hband[:, 0] + k, img.shape[1] - 1)
                acc = np.where(live, acc + rows[:, src] * whb[:, k], acc).astype(f32)
            ys = np.clip(np.round(acc), 0, 255).astype(f32)
            for o in range(t * r, min((t + 1) * r, c)):
                s = np.zeros(c, f32)
                for h in range(vband[o, 0], vband[o, 1]):
                    s = (s + wv[o, h] * ys[h - hlo]).astype(f32)
                z = np.clip(np.round(s), 0, 255).astype(f32)
                out[o, cols, ch] = z * f32(wts.scale[ch]) + f32(wts.shift[ch])
    return out


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("cfg", [CFG, debug_preprocess(debug_dual_config("dense"))], ids=["clip-l", "debug"])
def test_kernel_bands_cover_every_nonzero_weight(cfg, h, w):
    """The CUDA kernel sums each output over its band and computes each row
    tile from the input rows it is given; every weight outside them must be
    exactly zero, so the banded sums equal the dense ones."""
    wts = preprocess_weights(cfg, h, w, "cpu")
    wv, wh = tpre._cropped_weights(cfg, h, w)
    for m, band in ((wh, wts.hband.numpy()), (wv, wts.vband.numpy())):
        for row, (lo, hi) in zip(m, band):
            assert not row[:lo].any() and not row[hi:].any() and hi > lo
    whb = wts.whb.numpy()
    for p, (lo, hi) in enumerate(wts.hband.numpy()):
        assert np.array_equal(whb[p, : hi - lo], wh[p, lo:hi]) and not whb[p, hi - lo :].any()
    r = wts.rows_per_tile
    tiles = wts.tiles.numpy()
    assert tiles.shape[0] == -(-cfg.image_size // r)
    for t, (lo, hi) in enumerate(tiles):
        band = wts.vband.numpy()[t * r : (t + 1) * r]
        assert lo == band[:, 0].min() and hi == band[:, 1].max()
        assert (hi - lo) * cfg.image_size * 4 <= 200 * 1024
    assert 0 < wts.taps < h * w * cfg.image_size + h * cfg.image_size**2


@pytest.mark.parametrize("h,w", [(480, 640), (427, 640)])
def test_kernel_arithmetic_matches_plain(h, w):
    x = _images(h, w, b=1, seed=3)
    got = _emulate_kernel(x[0], preprocess_weights(CFG, h, w, "cpu"))[None]
    want = tpre.make_preprocess_fn(CFG, h, w, device="cpu", input_format="nchw")(torch.from_numpy(x)).numpy()
    _check_close(got, want, CFG)


def test_kernel_row_tiles_shrink_for_strong_downscale():
    cfg = debug_preprocess(debug_dual_config("dense"))
    wts = preprocess_weights(cfg, 4000, 4000, "cpu")
    assert wts.rows_per_tile < 32 and wts.max_span * cfg.image_size * 4 <= 200 * 1024


def test_kernel_fn_on_cpu_is_the_plain_version():
    h, w = 427, 640
    x = torch.from_numpy(_images(h, w))
    a = make_preprocess_cuda_fn(CFG, h, w, device="cpu")(x)
    b = tpre.make_preprocess_fn(CFG, h, w, device="cpu", input_format="nchw")(x)
    assert torch.equal(a, b)


def test_kernel_wrapper_rejects_cpu_tensors():
    from multimodal_embedding_tpu_torch.ops.preprocess_cuda import preprocess_cuda

    wts = preprocess_weights(CFG, 480, 640, "cpu")
    with pytest.raises(ValueError):
        preprocess_cuda(torch.zeros(1, 3, 480, 640, dtype=torch.uint8), wts)

