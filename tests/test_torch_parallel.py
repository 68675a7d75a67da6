"""The port's ``parallel/`` against the JAX package's, on the CPU.

Mirrors ``tests/test_tp.py``, ``tests/test_sp.py`` and
``tests/test_multihost.py`` case for case, at debug sizes. The spec and mesh
cases are pure functions, checked here with no process group. Every
distributed case runs in one world of 4 gloo ranks (``torch_parallel_world``,
spawned once for the module); the JAX side runs in this process on the
8-device CPU mesh of ``tests/conftest.py``, on the same numpy inputs and the
same weights (drawn by the JAX package, carried by ``params_from_jax``).

Tolerances (f32): tensor parallelism 5e-5 for the dual encoder and the
encoder stack, 2e-5 for packed attention, 3e-5 for Gemma; 2e-2 for 6 heads
over 4 ranks, where the attention stays whole and takes the bf16-logit
einsum (as JAX's test); ``sp_attention`` and the ColPali forwards under
sequence parallelism 3e-5; bit-equal where the model axis does not divide
the sequence (the whole sequence then runs on every rank), for MaxSim's
plain version, the bootstrap and dense scores at the JAX test's shapes on a
data mesh of 4 against one rank; dense scores at 37 x 512 within 1e-4
absolute of one rank's, scores of magnitude up to about 60 (a BLAS GEMM's
row results may depend on the row count: f32 sums in another order); the
stager's rows exact; the engine's embeddings on a data mesh of 4 within
1e-5 of one rank's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from multimodal_embedding_tpu.models import colpali as jcolpali
from multimodal_embedding_tpu.models import gemma as jgemma
from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu.models import towers as jtowers
from multimodal_embedding_tpu.parallel import mesh as jmesh
from multimodal_embedding_tpu.parallel import sp as jsp
from multimodal_embedding_tpu.parallel import tp as jtp
from multimodal_embedding_tpu_torch.models.colpali import debug_colpali_config
from multimodal_embedding_tpu_torch.models.gemma import Gemma, GemmaConfig
from multimodal_embedding_tpu_torch.models.params import params_from_jax
from multimodal_embedding_tpu_torch.models.towers import DualEncoder
from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config
from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh, get_multihost_mesh
from multimodal_embedding_tpu_torch.parallel.tp import tp_specs
from tests.torch_parallel_world import run_world
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

GEMMA = dict(vocab_size=64, dim=32, layers=2, heads=4, kv_heads=1, head_dim=8, mlp_dim=64)
SUFFIX6 = np.array([1, 7, 8, 9, 10, 11], np.int32)  # 4 patches + 6 suffix = 10 image tokens


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree):
    return params_from_jax(_np(tree), device="cpu")


def _jax_dual_cfg():
    cfg = debug_dual_config("dense")
    return jtowers.DualEncoderConfig(vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
                                     text=jtowers.TextConfig(**dataclasses.asdict(cfg.text)), family=cfg.family)


def _jax_colpali_cfg():
    cfg = debug_colpali_config()
    return jcolpali.ColPaliConfig(vision=jtowers.VisionConfig(**dataclasses.asdict(cfg.vision)),
                                  gemma=jgemma.GemmaConfig(**dataclasses.asdict(cfg.gemma)),
                                  embedding_dim=cfg.embedding_dim, image_token_id=cfg.image_token_id)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _with_biases(tree, seed: int):
    """``tree`` with every linear bias drawn nonzero (the inits give zeros,
    under which a bias added on every rank would go unseen)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        named_b = getattr(path[-1], "key", None) == "b"
        return jnp.asarray(_f32(rng, *leaf.shape) * 0.1) if named_b else leaf

    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX params and inputs, each rank's results) of one 4-rank world."""
    rng = np.random.default_rng(0)
    jp = {
        "dual": _with_biases(jtowers.dual_encoder_init(jax.random.key(0), _jax_dual_cfg()), 1),
        "enc": _with_biases(jlayers.encoder_stack_init(jax.random.key(22), 2, 512, 256), 2),
        "fb": _with_biases({n: jlayers.linear_init(jax.random.key(24 + i), 384, 384) for i, n in enumerate("qkvo")},
                           3),
        "gemma": jgemma.gemma_init(jax.random.key(1), jgemma.GemmaConfig(**GEMMA)),
        "cp": jcolpali.colpali_init(jax.random.key(0), _jax_colpali_cfg(), SUFFIX6),
    }
    mask = rng.random((4, 9)) < 0.8
    mask[:, 0] = True
    lengths = np.array([64, 40])
    ms_dmask = rng.random((12, 6)) < 0.8
    ms_dmask[:, 0] = True
    inp = {
        "px": _f32(rng, 8, 64, 64, 3), "ids": rng.integers(0, 512, (8, 64)).astype(np.int64),
        "qf": _f32(rng, 4, 9, 512), "kf": _f32(rng, 4, 9, 512), "vf": _f32(rng, 4, 9, 512), "attn_mask": mask,
        "enc_x": _f32(rng, 4, 17, 512), "fb_x": _f32(rng, 4, 7, 384),
        "gemma_x": _f32(rng, 4, 9, 32), "gemma_mask": np.ones((4, 9), np.int64), "gemma11_x": _f32(rng, 2, 11, 32),
        "sp_q": _f32(rng, 2, 4, 64, 16), "sp_k": _f32(rng, 2, 4, 64, 16), "sp_v": _f32(rng, 2, 4, 64, 16),
        "sp_k2": _f32(rng, 2, 2, 64, 16), "sp_v2": _f32(rng, 2, 2, 64, 16),
        "sp_mask": np.arange(64)[None, :] < lengths[:, None],
        "cp_px": _f32(rng, 2, 28, 28, 3), "cp_ids": rng.integers(2, 500, (2, 16)).astype(np.int64),
        "cp_mask": (np.arange(16)[None, :] < np.array([5, 12])[:, None]).astype(np.int64),
        "txt": _f32(rng, 64, 16), "img": _f32(rng, 64, 16), "txt_all": _f32(rng, 320, 16),
        "odd_q": _f32(rng, 37, 512), "odd_d": _f32(rng, 185, 512),
        "ms_q": _f32(rng, 10, 8, 16), "ms_d": _f32(rng, 12, 6, 16),
        "ms_qmask": (rng.random((10, 8)) < 0.7).astype(np.float32), "ms_dmask": ms_dmask,
    }
    tensors = {k: torch.from_numpy(v) for k, v in inp.items()}
    tensors.update(dual_sd=_sd(jp["dual"]), enc_sd=_sd({"layers": jp["enc"]}), fb_sd=_sd(jp["fb"]),
                   gemma_sd=_sd(jp["gemma"]), cp_sd=_sd(jp["cp"]), cp_suffix=SUFFIX6)
    outs = run_world("parallel", 4, tmp_path_factory.mktemp("world"), tensors)
    return jp, inp, outs


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        torch.testing.assert_close(o[key], outs[0][key], rtol=0, atol=0)
    return outs[0][key]


# --- specs and meshes: pure functions -------------------------------------------------


def _jax_spec_for(jspecs: dict, name: str) -> tuple:
    """The JAX spec of a port parameter name, less the stacked layer axis
    (the port's ``encoder.layers.<i>`` is the JAX ``encoder`` stack)."""
    parts = [p for p in name.split(".") if not p.isdigit() and p != "layers"]
    node = jspecs
    for key in parts:
        node = node[key]
    return tuple(node)[1:] if ".layers." in f".{name}" and tuple(node) else tuple(node)


def test_tp_specs_place_column_and_row_splits():
    cfg = debug_dual_config("dense")
    model = DualEncoder(cfg, device="cpu")
    specs = tp_specs(model, n_model=4)
    enc = "vision.encoder.layers.0"
    assert specs[f"{enc}.attn.q.w"] == (None, "model")
    assert specs[f"{enc}.attn.q.b"] == ("model",)
    assert specs[f"{enc}.attn.o.w"] == ("model", None)
    assert specs[f"{enc}.attn.o.b"] == ()
    assert specs[f"{enc}.mlp.fc1.w"] == (None, "model")
    assert specs[f"{enc}.mlp.fc2.w"] == ("model", None)
    assert specs["vision.pos"] == () and specs["text.tok"] == ()
    # every leaf as the JAX function places it on the same tree
    jspecs = jtp.tp_specs(jtowers.dual_encoder_init(jax.random.key(0), _jax_dual_cfg()), 4)
    for name, spec in specs.items():
        assert spec == _jax_spec_for(jspecs, name), name


def test_tp_specs_fall_back_to_replication_on_indivisible_dims():
    specs = tp_specs(DualEncoder(debug_dual_config("dense"), device="cpu"), n_model=7)
    assert all(s == () for s in specs.values())


def test_tp_gemma_specs():
    specs = tp_specs(Gemma(GemmaConfig(**GEMMA), gen=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32), n_model=4)
    lay = "layers.0"
    assert specs[f"{lay}.attn.q"] == (None, "model")
    assert specs[f"{lay}.attn.o"] == ("model", None)
    assert specs[f"{lay}.mlp.gate"] == (None, "model")
    assert specs[f"{lay}.mlp.up"] == (None, "model")
    assert specs[f"{lay}.mlp.down"] == ("model", None)
    assert specs["embed"] == ()
    jspecs = jtp.tp_specs(jgemma.gemma_init(jax.random.key(0), jgemma.GemmaConfig(**GEMMA)), 4)
    assert jspecs["layers"]["attn"]["k"] == P(None, None, "model")
    assert specs[f"{lay}.attn.k"] == (None, "model")  # the name rule; shard_params_tp keeps whole KV heads


def test_get_mesh_rejects_oversized_model_axis():
    with pytest.raises(ValueError, match="tensor-parallel"):
        get_mesh(n_model=2, world=1)
    with pytest.raises(ValueError, match="devices"):
        get_mesh(n_data=4, n_model=1, world=1)
    mesh = get_mesh(n_model=2, world=8)
    assert mesh.shape == {"data": 4, "model": 2}
    # the JAX function refuses the same shapes with the same words
    with pytest.raises(ValueError, match="tensor-parallel"):
        jmesh.get_mesh(n_model=2, devices=jax.devices()[:1])


def test_multihost_mesh_shape_and_axes():
    mesh = get_multihost_mesh(n_model=1, world=8, local_world=4)
    assert tuple(mesh.shape) == ("data", "model")
    assert mesh.shape == {"data": 8, "model": 1}
    assert get_multihost_mesh(n_model=2, world=8, local_world=4).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        get_multihost_mesh(n_model=8, world=16, local_world=4)  # a model axis across hosts


# --- tensor parallelism ---------------------------------------------------------------


def test_tp_dual_encoder_image_matches_jax(world):
    jp, inp, outs = world
    want = jtowers.encode_image(jp["dual"], _jax_dual_cfg(), jnp.asarray(inp["px"]))
    assert outs[0]["tp_q_shape"] == (64, 32)  # this rank's 2 of 4 heads
    _close(_same_on_every_rank(outs, "tp_img"), want, 5e-5)


def test_tp_dual_encoder_text_matches_jax(world):
    jp, inp, outs = world
    want = jtowers.encode_text(jp["dual"], _jax_dual_cfg(), jnp.asarray(inp["ids"], jnp.int32))
    _close(_same_on_every_rank(outs, "tp_txt"), want, 5e-5)


def test_tp_packed_attention_kernel_matches_jax(world):
    _, inp, outs = world
    want = jlayers.attention_core(jnp.asarray(inp["qf"]), jnp.asarray(inp["kf"]), jnp.asarray(inp["vf"]), 8,
                                  mask=jnp.asarray(inp["attn_mask"]))
    _close(_same_on_every_rank(outs, "tp_attn"), want, 2e-5)


def test_tp_encoder_with_kernel_route_matches_jax(world):
    jp, inp, outs = world
    want = jlayers.encoder_stack(jp["enc"], jnp.asarray(inp["enc_x"]), 8, "gelu")
    _close(_same_on_every_rank(outs, "tp_encoder"), want, 5e-5)


def test_tp_unfriendly_heads_fall_back_cleanly(world):
    jp, inp, outs = world
    assert outs[0]["fb_whole"] == ((384, 384), 6, True)  # kept whole, all 6 heads, no reduce
    want = jlayers.mha(jp["fb"], jnp.asarray(inp["fb_x"]), 6)
    for o in outs:
        _close(o["fb"], want, 2e-2)


def test_tp_gemma_matches_jax(world):
    jp, inp, outs = world
    want = jgemma.gemma_apply(jp["gemma"], jgemma.GemmaConfig(**GEMMA), jnp.asarray(inp["gemma_x"]),
                              jnp.asarray(inp["gemma_mask"], jnp.int32))
    _close(_same_on_every_rank(outs, "tp_gemma"), want, 3e-5)


# --- sequence parallelism -------------------------------------------------------------


def _jax_sp(inp, k, v, mask=None, causal=False):
    mesh = jmesh.get_mesh(n_data=1, n_model=4, devices=jax.devices()[:4])
    act, msh = jsp.sp_shardings(mesh)
    args = [jax.device_put(jnp.asarray(x), act) for x in (inp["sp_q"], inp[k], inp[v])]
    km = None if mask is None else jax.device_put(jnp.asarray(mask), msh)
    return jsp.sp_attention(*args, mesh, key_mask=km, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_sp_attention_matches_jax(world, causal):
    _, inp, outs = world
    _close(_same_on_every_rank(outs, f"sp_{causal}"), _jax_sp(inp, "sp_k", "sp_v", causal=causal), 3e-5)


def test_sp_attention_key_mask_and_gqa(world):
    _, inp, outs = world
    want = _jax_sp(inp, "sp_k2", "sp_v2", inp["sp_mask"], causal=True)
    _close(_same_on_every_rank(outs, "sp_gqa_mask"), want, 3e-5)


def test_sp_attention_output_stays_sequence_sharded(world):
    _, _, outs = world
    for o in outs:
        assert o["sp_local_shape_False"] == (2, 4, 16, 16)  # [B, H, T/4, Dh]


def _jax_colpali(jp, inp):
    cfg = _jax_colpali_cfg()
    img = jcolpali.colpali_image_fwd(jp["cp"], cfg, jnp.asarray(inp["cp_px"]))
    txt = jcolpali.colpali_text_fwd(jp["cp"], cfg, jnp.asarray(inp["cp_ids"], jnp.int32),
                                    jnp.asarray(inp["cp_mask"], jnp.int32))
    return img, txt


def test_colpali_sp2_image_and_text_match_jax(world):
    """10 image tokens and 16 query tokens, both split over 2 ranks."""
    jp, inp, outs = world
    want_img, want_txt = _jax_colpali(jp, inp)
    for o in outs:
        assert o["cp_img_sp2_sp_calls"] == 2 and o["cp_txt_sp2_sp_calls"] == 2  # every Gemma layer sharded
        _close(o["cp_img_sp2"], want_img, 3e-5)
        _close(o["cp_txt_sp2"], want_txt, 3e-5)


def test_colpali_sp4_matches_jax_and_falls_through_on_10_tokens(world):
    """Over 4 ranks the 16 query tokens split; the 10 image tokens do not
    divide 4 and run whole on every rank, bit-equal to the unsharded port."""
    jp, inp, outs = world
    want_img, want_txt = _jax_colpali(jp, inp)
    for o in outs:
        assert o["cp_img_sp4_sp_calls"] == 0 and o["cp_txt_sp4_sp_calls"] == 2
        torch.testing.assert_close(o["cp_img_sp4"], o["cp_img_alone"], rtol=0, atol=0)
        _close(o["cp_img_sp4"], want_img, 3e-5)
        _close(o["cp_txt_sp4"], want_txt, 3e-5)


def test_sp_mesh_skips_indivisible_sequences(world):
    _, _, outs = world
    for o in outs:
        assert o["gemma11_sp_calls"] == 0
        torch.testing.assert_close(o["gemma11_sp4"], o["gemma11_alone"], rtol=0, atol=0)


# --- data parallelism: scoring, bootstrap, staging -------------------------------------


@pytest.mark.parametrize("tag", ["flat", "multi"])
def test_scoring_and_bootstrap_bit_identical_to_one_rank(world, tag):
    _, _, outs = world
    for o in outs:
        for got, want in zip(o[f"scores_{tag}"], o["scores_alone"]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        metrics, correct, idx = o[f"boot_{tag}"]
        metrics_1, correct_1, idx_1 = o["boot_alone"]
        for key in metrics_1:
            np.testing.assert_array_equal(metrics[key], metrics_1[key])
        np.testing.assert_array_equal(correct, correct_1)
        np.testing.assert_array_equal(idx, idx_1)
        torch.testing.assert_close(o[f"maxsim_{tag}"], o["maxsim_alone"], rtol=0, atol=0)


def test_dense_scores_at_an_odd_row_count(world):
    _, inp, outs = world
    for o in outs:
        torch.testing.assert_close(o["odd_flat"], o["odd_alone"], rtol=0, atol=1e-4)
        assert o["odd_flat"].shape == (37, 185)
    _close(outs[0]["odd_alone"], inp["odd_q"] @ inp["odd_d"].T, 1e-4)


def test_stager_stages_each_rank_rows(world):
    """Rank r holds rows [8b + 2r, 8b + 2r + 2) of each geometry's padded
    batches (the last index repeated as the pad), from the background stager
    and from stage_images alike."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (48, 64, 3) if i % 3 else (64, 48, 3), dtype=np.uint8) for i in range(11)]
    _, _, outs = world
    for rank, o in enumerate(outs):
        for key in ("stager_rows", "staged_rows"):
            for (h, w), idxs, dev, count in o[key]:
                assert count == len(idxs) and dev.shape[1:] == (2, 3, h, w)
                for b in range(dev.shape[0]):
                    for j in range(2):
                        i = idxs[min(8 * b + 2 * rank + j, count - 1)]
                        np.testing.assert_array_equal(dev[b, j].numpy(), images[i].transpose(2, 0, 1))


def test_engine_on_a_data_mesh_matches_one_rank(world):
    _, _, outs = world
    for o in outs:
        assert o["engine_dp"].shape == o["engine_alone"].shape == (11, 32)
        torch.testing.assert_close(o["engine_dp"], o["engine_alone"], rtol=1e-5, atol=1e-5)
