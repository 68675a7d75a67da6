"""The towers' MLP activation (``ops/activation_cuda.py``) on the CPU.

On CPU tensors :func:`mlp_activation` is the plain version, which must equal
the inline line ``MLP.forward`` ran before the kernel existed,
``ACTIVATIONS[act](h.float()).to(x.dtype)``, bit for bit, in every dtype the
kernel takes; ``MLP.forward`` is unchanged on the CPU. The plain version
agrees with the JAX package's activation line within one rounding of the
storage type. The kernel wrapper's checks that come before any launch (dtype,
contiguity, alignment), its launch count, its profiler span and the autograd
Function's recomputed backward run here with the kernel call replaced: the
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu_torch import ops
from multimodal_embedding_tpu_torch.models.layers import MLP
from multimodal_embedding_tpu_torch.ops import activation_cuda
from multimodal_embedding_tpu_torch.ops.activation_cuda import mlp_activation
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ACTS = ("gelu", "quick_gelu", "gelu_pytorch_tanh")
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# the activation line of MLP.forward before the kernel, written out
INLINE = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_pytorch_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}


def _inputs(dtype) -> torch.Tensor:
    """Normals at three scales, the edges of the activations' branches, the
    storage type's extremes and subnormals, and the infinities."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.standard_normal(4000) * s for s in (0.1, 3.0, 30.0)]).astype(np.float32)
    fi = torch.finfo(dtype)
    edges = [0.0, -0.0, 0.5, -0.5, 0.6, -0.6, 5.0, -5.0, 9.0, -9.0, 88.0, -88.0, 1e-3, -1e-3,
             fi.max, -fi.max, fi.tiny, -fi.tiny, fi.tiny / 4, -fi.tiny / 4, np.inf, -np.inf]
    return torch.cat([torch.from_numpy(vals), torch.tensor(edges, dtype=torch.float32)]).to(dtype).reshape(2, -1)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_cpu_activation_is_the_inline_line(act, dtype):
    h = _inputs(dtype)
    got = mlp_activation(h, act)
    want = INLINE[act](h.float()).to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    num = ~want.isnan()
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.view(bits)[num], want.view(bits)[num])


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_cpu_mlp_forward_unchanged(act, dtype):
    gen = torch.Generator().manual_seed(3)
    mlp = MLP(48, 136, act, gen=gen, device="cpu", dtype=dtype)
    torch.nn.init.normal_(mlp.fc1.b, generator=gen)
    x = torch.randn(2, 9, 48, generator=gen).to(dtype)
    with torch.no_grad():
        got = mlp(x)
        h = INLINE[act](mlp.fc1(x).float()).to(x.dtype)
        want = mlp.fc2(h)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("act", ACTS)
def test_cpu_activation_matches_jax_line(act):
    """bf16 in, bf16 out: JAX's CPU erf and tanh are other approximations,
    so within one bf16 rounding; and XLA's CPU flushes subnormal results to
    zero, so within 1e-6 absolute near zero."""
    h = _inputs(torch.bfloat16)
    h = h[h.float().abs() < 1e30]  # finite, away from overflow in x^3
    got = mlp_activation(h, act).float().numpy()
    want = np.asarray(jlayers.ACTIVATIONS[act](jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
                                               .astype(jnp.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "gelu_new", "", None])
def test_unknown_activation_raises(act):
    with pytest.raises(ValueError, match="act must be one of"):
        mlp_activation(torch.zeros(4, 8), act)


def test_launch_counts_list_mlp_activation():
    assert "mlp_activation" in ops.LAUNCH_KEYS
    assert "mlp_activation" in ops.launch_counts()


@pytest.mark.parametrize("case", ["dtype", "non-contiguous", "misaligned"])
def test_kernel_wrapper_rejects_before_launch(case):
    """The checks the wrapper makes before it builds or launches anything."""
    if case == "dtype":
        h, err, match = torch.zeros(4, 8, dtype=torch.float64), TypeError, "float32, bfloat16 or float16"
    elif case == "non-contiguous":
        h, err, match = torch.zeros(8, 16, dtype=torch.bfloat16).t(), ValueError, "contiguous"
    else:
        h, err, match = torch.zeros(65, dtype=torch.bfloat16)[1:], ValueError, "16-byte aligned"
    with pytest.raises(err, match=match):
        activation_cuda._run(h, "quick_gelu")


def _plain_run(h, act):
    """Stands in for the kernel call: the plain version."""
    return activation_cuda.reference(h, act)


def test_launch_counts_and_span(monkeypatch):
    """One count a launch, none for an empty tensor; the span
    ``mme.kernel.mlp_activation`` while a profiler records."""
    monkeypatch.setattr(KERNELS, "counts", {})
    monkeypatch.setattr(activation_cuda, "_run", _plain_run)
    h = torch.randn(3, 16).to(torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            activation_cuda._launch(h, "quick_gelu")
    activation_cuda._launch(h[:0], "quick_gelu")
    assert ops.launch_counts()["mlp_activation"] == 3
    names = [e.name for e in prof.events()]
    assert names.count("mme.kernel.mlp_activation") == 3


@pytest.mark.parametrize("act", ACTS)
def test_autograd_function_recomputes_through_plain(act, monkeypatch):
    """The Function's forward is the kernel's (here the plain version); its
    backward equals autograd through the plain version."""
    monkeypatch.setattr(activation_cuda, "_run", _plain_run)
    gen = torch.Generator().manual_seed(5)
    h0 = (torch.randn(6, 24, generator=gen) * 3).to(torch.bfloat16)
    g = torch.randn(6, 24, generator=gen).to(torch.bfloat16)
    h = h0.clone().requires_grad_()
    y = activation_cuda._MLPActivation.apply(h, act)
    y.backward(g)
    href = h0.clone().requires_grad_()
    want = activation_cuda.reference(href, act)
    want.backward(g)
    assert torch.equal(y.detach(), want.detach())
    assert torch.equal(h.grad, href.grad)
