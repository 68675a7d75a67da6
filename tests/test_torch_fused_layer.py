"""The port's ``--layer-impl fused`` path against the JAX package's, on the CPU.

On CPU tensors each wrapper takes its kernel's plain version; the JAX Pallas
kernels run in interpret mode, as ``tests/test_fused_layer.py`` runs them.
Inputs are made with numpy from a seed and weights are drawn by the JAX
package and carried in by ``params_from_jax``. Tolerances, all f32:
- the prologue: ``x_new`` 1e-6 and ``y`` 2e-5 against the JAX kernel forced
  to a multi-block grid (``tests/test_fused_layer.py``'s); its plain row pass
  against the JAX ``_reference``'s intermediates: ``x_new`` bit-equal, ``h``
  1e-5 in f32 and one bf16 rounding (2^-8) in bf16;
- stacked-QKV attention and LayerNorm: 1e-5;
- the fused encoder stack: 5e-5 with attention "xla" on both sides and 1e-4
  with "pallas" on both sides (the JAX tests' own), 5e-5 against the port's
  own "xla" layer; the vision tower 5e-5; ColPali's image forward 1e-4;
  gradients 1e-4;
- the benchmark row: ``tests/test_torch_slice.py``'s (scores 1e-4, each
  metric within one query given the JAX package's samples).

The layer and attention switches are module state in both packages: every
test restores them.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import colpali as jcolpali
from multimodal_embedding_tpu.models import gemma as jgemma
from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models import towers as jtowers
from multimodal_embedding_tpu.ops.attention_pallas import fused_attention_qkv as jax_attention_qkv
from multimodal_embedding_tpu.ops.fused_ln_matmul import fused_res_norm_matmul as jax_prologue
from multimodal_embedding_tpu.ops.layernorm_pallas import fused_layer_norm as jax_layer_norm
from multimodal_embedding_tpu_torch.models import layers as tlayers
from multimodal_embedding_tpu_torch.models.colpali import ColPali, debug_colpali_config
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config
from multimodal_embedding_tpu_torch.ops import attention_cuda, fused_ln_matmul_cuda, layernorm_cuda

N_IMAGES, ITERS, BATCH, SEED = 32, 20, 16, 42


@contextlib.contextmanager
def impls(layer: str, attention: str = "xla"):
    """Both packages' layer and attention switches, restored on exit."""
    saved = (jlayers._LAYER_IMPL, jlayers._ATTENTION_IMPL, tlayers._LAYER_IMPL, tlayers._ATTENTION_IMPL)
    try:
        jlayers.set_layer_impl(layer)
        tlayers.set_layer_impl(layer)
        jlayers.set_attention_impl(attention)
        tlayers.set_attention_impl(attention)
        yield
    finally:
        jlayers._LAYER_IMPL, jlayers._ATTENTION_IMPL, tlayers._LAYER_IMPL, tlayers._ATTENTION_IMPL = saved


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- the prologue kernel ------------------------------------------------------------


def _prologue_inputs(shape, n, has_delta, norm, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    delta = rng.standard_normal(shape).astype(np.float32) if has_delta else None
    gamma = rng.standard_normal(d).astype(np.float32) * 0.1
    beta = rng.standard_normal(d).astype(np.float32) * 0.1 if norm == "ln" else None
    w = rng.standard_normal((d, n)).astype(np.float32) * 0.1
    b = rng.standard_normal(n).astype(np.float32) * 0.1 if norm == "ln" else None
    return x, delta, gamma, beta, w, b


@pytest.mark.parametrize(
    "m,d,n,has_delta,act,norm",
    [
        (24, 64, 96, True, None, "ln"),  # QKV-prologue shape class
        (24, 64, 96, False, None, "ln"),  # first sublayer (no residual)
        (17, 64, 48, True, "quick_gelu", "ln"),  # MLP prologue, odd rows
        (24, 64, 40, True, "gelu_pytorch_tanh", "ln"),  # odd N tail
        (16, 32, 64, True, None, "rms_gemma"),  # Gemma RMS prologue
        (16, 32, 64, False, None, "rms_gemma"),
    ],
)
def test_prologue_matches_jax_kernel(m, d, n, has_delta, act, norm):
    args = _prologue_inputs((m, d), n, has_delta, norm, seed=0)
    want = jax_prologue(*map(_j, args), norm=norm, act=act, interpret=True, block_m=8, block_n=32)
    got = fused_ln_matmul_cuda.fused_res_norm_matmul(*map(_t, args), norm=norm, act=act)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5, rtol=2e-5)


def test_prologue_batched_input_matches_jax_kernel():
    args = _prologue_inputs((2, 9, 64), 32, True, "ln", seed=3)
    want = jax_prologue(*map(_j, args), interpret=True, block_m=8, block_n=32)
    got = fused_ln_matmul_cuda.fused_res_norm_matmul(*map(_t, args))
    assert got[0].shape == (2, 9, 64) and got[1].shape == (2, 9, 32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5, rtol=2e-5)


def test_prologue_rounds_where_the_jax_reference_rounds():
    """In bf16 the plain version rounds x_new, h and y before the activation:
    its output equals the JAX ``_reference`` run in bf16 bit for bit on
    x_new and to one bf16 rounding on y (sums in another order)."""
    from multimodal_embedding_tpu.ops.fused_ln_matmul import _reference

    args = _prologue_inputs((12, 64, 64), 48, True, "ln", seed=4)
    want = _reference(*(None if a is None else jnp.asarray(a, jnp.bfloat16) for a in args),
                      norm="ln", eps=1e-5, act="quick_gelu")
    got = fused_ln_matmul_cuda.reference(*(None if a is None else _t(a).bfloat16() for a in args),
                                         norm="ln", eps=1e-5, act="quick_gelu")
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_allclose(got[1].float().numpy(), np.asarray(want[1].astype(jnp.float32)), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_delta", [True, False])
@pytest.mark.parametrize("norm", ["ln", "rms_gemma"])
def test_prologue_row_pass_matches_jax_reference_intermediates(dtype, has_delta, norm):
    """The plain row pass against the intermediates of the JAX ``_reference``:
    its ``x_new`` and ``_norm_f32(x_new).astype(dtype)``. ``x_new`` is one
    rounding of the same f32 sum, so bit-equal; ``h`` is f32 arithmetic in
    another order (``jnp.var`` against ``mean((x - mu)^2)``), so 1e-5 in f32
    and within one bf16 rounding (2^-8 relative, 2^-8 absolute near zero) in
    bf16."""
    from multimodal_embedding_tpu.ops.fused_ln_matmul import _norm_f32, _reference

    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    x, delta, gamma, beta, w, b = _prologue_inputs((2, 9, 96), 16, has_delta, norm, seed=17)
    jx, jdelta, jgamma, jbeta, jw, jb = (None if a is None else jnp.asarray(a, jdt) for a in (x, delta, gamma, beta, w, b))
    want_x, _ = _reference(jx, jdelta, jgamma, jbeta, jw, jb, norm=norm, eps=1e-5, act=None)
    beta_f = jbeta.astype(jnp.float32) if jbeta is not None else 0.0
    want_h = _norm_f32(want_x.astype(jnp.float32), jgamma.astype(jnp.float32), beta_f, norm=norm, eps=1e-5).astype(jdt)
    got_x, got_h = fused_ln_matmul_cuda.reference_rows(
        *(None if a is None else _t(a).to(tdt) for a in (x, delta, gamma, beta)), norm=norm, eps=1e-5)
    assert got_x.dtype == got_h.dtype == tdt and got_h.shape == (2, 9, 96)
    np.testing.assert_array_equal(got_x.float().numpy(), np.asarray(want_x.astype(jnp.float32)))
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got_h.float().numpy(), np.asarray(want_h.astype(jnp.float32)), atol=tol, rtol=tol)


def test_prologue_rejects_what_it_does_not_take():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        fused_ln_matmul_cuda.fused_res_norm_matmul(x, None, torch.ones(16), None, torch.zeros(8, 4), None)
    with pytest.raises(ValueError):
        fused_ln_matmul_cuda.fused_res_norm_matmul(x, None, torch.ones(16), None, torch.zeros(16, 4), None,
                                                   norm="rms")


# --- stacked-QKV attention and LayerNorm ----------------------------------------------


@pytest.mark.parametrize("case", ["unmasked", "causal+mask", "fully masked row"])
def test_attention_qkv_matches_jax_kernel(case):
    rng = np.random.default_rng(5)
    b, t, h, dh = 3, 21, 4, 64
    qkv = rng.standard_normal((b, t, 3 * h * dh)).astype(np.float32)
    km = None
    if case != "unmasked":
        km = (np.arange(t)[None, :] < np.array([[t], [t - 6], [9]])).astype(bool)
        if case == "fully masked row":
            km[2] = False  # every query row of sequence 2 is fully masked
    causal = case == "causal+mask"
    want = jax_attention_qkv(jnp.asarray(qkv), _j(km), causal=causal, num_heads=h, interpret=True)
    got = attention_cuda.fused_attention_qkv(_t(qkv), _t(km), causal=causal, num_heads=h)
    assert got.shape == (b, t, h * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if case == "fully masked row":
        assert bool((got[2] == 0).all())


def test_attention_qkv_equals_attention_on_the_slices():
    rng = np.random.default_rng(6)
    h, kvh, dh = 4, 2, 16
    qkv = _t(rng.standard_normal((2, 13, (h + 2 * kvh) * dh)).astype(np.float32))
    km = _t((np.arange(13)[None, :] < np.array([[13], [5]])).astype(np.int32))
    got = attention_cuda.fused_attention_qkv(qkv, km, causal=True, num_heads=h, num_kv_heads=kvh)
    q, k, v = qkv[..., : h * dh], qkv[..., h * dh : (h + kvh) * dh], qkv[..., (h + kvh) * dh :]
    want = attention_cuda.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), km, causal=True,
                                          layout="packed", num_heads=h, num_kv_heads=kvh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,eps", [((37, 64), 1e-5), ((2, 9, 1152), 1e-6)])
def test_layer_norm_matches_jax_kernel(shape, eps):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=eps, interpret=True)
    got = layernorm_cuda.fused_layer_norm(_t(x), _t(scale), _t(bias), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_layer_norm_gradient_is_the_plain_versions():
    rng = np.random.default_rng(8)
    x, s, b = (_t(rng.standard_normal(sh).astype(np.float32)).requires_grad_() for sh in ((5, 32), (32,), (32,)))
    (layernorm_cuda.fused_layer_norm(x, s, b) ** 2).sum().backward()
    got = [t.grad.clone() for t in (x, s, b)]
    for t in (x, s, b):
        t.grad = None
    (torch.nn.functional.layer_norm(x, (32,), s, b, 1e-5) ** 2).sum().backward()
    for g, t in zip(got, (x, s, b)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-4, rtol=1e-4)


# --- the fused encoder stack ------------------------------------------------------------


def _encoder_pair(seed, n_layers, dim, heads, mlp, act="quick_gelu", ln_eps=1e-5):
    stacked = jlayers.encoder_stack_init(jax.random.key(seed), n_layers, dim, mlp)
    holder = torch.nn.Module()
    holder.encoder = tlayers.Encoder(n_layers, dim, heads, mlp, act, ln_eps, gen=torch.Generator(), device="cpu",
                                     dtype=torch.float32)
    holder.load_state_dict(params_from_jax({"encoder": jax.tree.map(np.asarray, stacked)}, device="cpu"))
    return stacked, holder.encoder


def _stack_inputs(masked, bsz=2, t=21, dim=128):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((bsz, t, dim)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[t], [t - 6]])).astype(bool) if masked else None
    return x, mask


@pytest.mark.parametrize("attention,tol", [("xla", 5e-5), ("pallas", 1e-4)])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (False, True)])
def test_fused_stack_matches_jax_fused_stack(attention, tol, causal, masked):
    dim, heads, mlp = 128, 2, 192  # Dh 64: the JAX package's stacked-QKV kernel route
    stacked, enc = _encoder_pair(10, 2, dim, heads, mlp)
    x, mask = _stack_inputs(masked, dim=dim)
    with impls("fused", attention), torch.no_grad():
        want = jlayers.encoder_stack(stacked, jnp.asarray(x), heads, "quick_gelu", causal=causal, mask=_j(mask))
        got = enc(_t(x), causal=causal, mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (False, True)])
def test_fused_stack_matches_the_ports_xla_stack(causal, masked):
    _, enc = _encoder_pair(11, 3, 64, 4, 96)
    x, mask = _stack_inputs(masked, bsz=2, t=13, dim=64)
    with torch.no_grad():
        with impls("fused"):
            got = enc(_t(x), causal=causal, mask=_t(mask))
        with impls("xla"):
            want = enc(_t(x), causal=causal, mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=5e-5)


def test_fused_stack_gradients_match_the_ports_xla_stack():
    _, enc = _encoder_pair(12, 2, 64, 4, 96)
    x, _ = _stack_inputs(False, bsz=2, t=9, dim=64)
    params = list(enc.parameters())
    grads = {}
    for impl in ("fused", "xla"):
        for p in params:
            p.requires_grad_(True)
            p.grad = None
        xt = _t(x).requires_grad_()
        with impls(impl):
            (enc(xt) ** 2).sum().backward()
        grads[impl] = [xt.grad] + [p.grad.clone() for p in params]
    for p in params:
        p.requires_grad_(False)
    for g, w in zip(grads["fused"], grads["xla"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


def test_layer_impl_switch():
    with impls("auto"):
        assert tlayers.get_layer_impl() == jlayers.get_layer_impl() == "xla"
        tlayers.set_layer_impl("fused")
        assert tlayers.get_layer_impl() == "fused"
        with pytest.raises(ValueError):
            tlayers.set_layer_impl("pallas")


def _as_jax_cfg(cfg):
    return jtowers.DualEncoderConfig(
        vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jtowers.TextConfig(**dataclasses.asdict(cfg.text)),
        family=cfg.family,
    )


def test_vision_tower_fused_matches_jax_fused():
    cfg = debug_dual_config("dense")
    jparams = jtowers.dual_encoder_init(jax.random.key(13), _as_jax_cfg(cfg))
    model = DualEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    px = np.random.default_rng(14).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with impls("fused"), torch.no_grad():
        want = jtowers.encode_image(jparams, _as_jax_cfg(cfg), jnp.asarray(px))
        got = model.encode_image(_t(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("attention", ["xla", "pallas"])
def test_colpali_image_fwd_fused_matches_jax_fused(attention):
    """The headless SigLIP tower (LayerNorm eps 1e-6) through the fused stack."""
    cfg = debug_colpali_config()
    jcfg = jcolpali.ColPaliConfig(
        vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
        gemma=jgemma.GemmaConfig(**dataclasses.asdict(cfg.gemma)),
        embedding_dim=cfg.embedding_dim, image_token_id=cfg.image_token_id,
    )
    suffix = np.array([1, 7, 8, 9], np.int32)
    jparams = jcolpali.colpali_init(jax.random.key(15), jcfg, suffix)
    model = ColPali(cfg, suffix, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    px = np.random.default_rng(16).standard_normal((3, 28, 28, 3)).astype(np.float32)
    with impls("fused", attention), torch.no_grad():
        want = jcolpali.colpali_image_fwd(jparams, jcfg, jnp.asarray(px))
        got = model.image_fwd(_t(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# --- the benchmark row ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_pair():
    from multimodal_embedding_tpu.data.synthetic import synthetic_retrieval_dataset
    from multimodal_embedding_tpu.models.registry import get_models_to_test as jax_models
    from multimodal_embedding_tpu.models.zoo import load_debug_model as jax_load_debug_model
    from multimodal_embedding_tpu_torch.models.registry import get_models_to_test
    from multimodal_embedding_tpu_torch.models.zoo import load_debug_model

    records = synthetic_retrieval_dataset(N_IMAGES, seed=SEED)
    (jinfo,) = jax_models("OpenAI-CLIP-L", BATCH)
    (tinfo,) = get_models_to_test("OpenAI-CLIP-L", BATCH)
    jmodel = jax_load_debug_model(jinfo, seed=SEED)
    tmodel = load_debug_model(tinfo, seed=SEED, device="cpu")
    tmodel.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    return records, jmodel, tmodel


def test_fused_scores_and_csv_row_match_jax(slice_pair):
    from multimodal_embedding_tpu.cli import main as jcli
    from multimodal_embedding_tpu.models.encode import EncodingEngine as JaxEngine
    from multimodal_embedding_tpu.parallel.mesh import get_mesh
    from multimodal_embedding_tpu.stats.bootstrap import bootstrap_benchmark as jax_bootstrap
    from multimodal_embedding_tpu_torch.cli import main as tcli
    from multimodal_embedding_tpu_torch.models.encode import EncodingEngine, stage_images

    records, jmodel, tmodel = slice_pair
    mesh = get_mesh()
    with impls("fused", "auto"):
        jengine = JaxEngine(jmodel, mesh, batch_size=BATCH, transport="device")
        js_t2i, js_i2t, _ = jcli.compute_score_matrices(jmodel, jengine, records, mesh=mesh)
        cache = stage_images([r["image"] for r in records], BATCH, "cpu")
        ts_t2i, ts_i2t, _ = tcli.compute_score_matrices(tmodel, EncodingEngine(tmodel, BATCH, device="cpu"),
                                                        records, cache=cache)
        np.testing.assert_allclose(ts_t2i.numpy(), np.asarray(js_t2i), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ts_i2t.numpy(), np.asarray(js_i2t), atol=1e-4, rtol=0)

        want = jcli.run_bootstrap_benchmark(jmodel, records, ITERS, mesh, batch_size=BATCH, seed=SEED,
                                            transport="device")
        sample_idx = jax_bootstrap(js_t2i, js_i2t, ITERS, seed=SEED).sample_idx
        ci_idx = np.asarray(jax.random.randint(jax.random.key(0), (10_000, ITERS), 0, ITERS))
        got = tcli.run_bootstrap_benchmark(tmodel, records, ITERS, device="cpu", batch_size=BATCH, seed=SEED,
                                           cache=cache, sample_idx=sample_idx, ci_idx=ci_idx)
    assert list(got) == list(want)
    one_query = 100.0 / N_IMAGES
    for key, val in want.items():
        if key.endswith(("_mean", "_lower", "_upper")):
            assert abs(got[key] - val) <= one_query + 1e-4, key
    assert set(json.loads(got["_failure_analysis"])) == set(json.loads(want["_failure_analysis"]))


def test_port_cli_runs_the_fused_layer(tmp_path):
    import pandas as pd

    from multimodal_embedding_tpu_torch.cli import main as tcli

    out = tmp_path / "fused.csv"
    with impls("auto", "auto"):
        rc = tcli.main(["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--models", "OpenAI-CLIP-L",
                        "--sample-size", "16", "--bootstrap-iterations", "8", "--batch-size", "8",
                        "--layer-impl", "fused", "--output", str(out)])
        assert tlayers.get_layer_impl() == "fused"
    assert rc == 0
    df = pd.read_csv(out)
    want_cols = ["Model", "Weights"] + [
        f"{p}_R@{k}_{s}" for p in ("T2I", "I2T", "I2T_Sym") for k in (1, 5, 10)
        for s in ("mean", "lower", "upper", "std")
    ] + ["Time", "QPS", "Encoding_Time", "Img_per_sec", "_failure_analysis"]
    assert list(df.columns) == want_cols
    assert np.isfinite(df[want_cols[2:-1]].to_numpy(dtype=float)).all()
