"""The Mamba-2 scan's equations at the chunk the card's kernel walks (64
tokens), on the CPU, and the rule that picks the kernel's body.

- ``ops/ssm.py:scan_plain`` at chunk 64 against the recurrence written out
  token by token in f32, here: lengths 1, 16, 63, 64, 65 and 130 (one token,
  a partial chunk, the chunk's edge, two chunks and a tail), within 2e-5 of
  the output's largest magnitude (the two read at most 1.9e-6 apart: the
  chunked form takes each decay as the difference of two f32 cumulative
  sums); right-padded rows as the Granite mixer pads them (x, B and C zero
  past a row's length) keep the outputs of the row scanned alone; decays near
  1 over 1030 tokens (dt about 1e-3, A about -1), where the recurrence with
  its decays rounded to bf16 reads 3.6e-2 to 1.1e-1 away.
- ``ops/ssm_cuda.py:uses_chunked``: bf16 takes the chunked body, f32 the
  recurrent one; a launch counts as ``ssm_scan``, and a chunked one also as
  ``ssm_scan_chunked`` (the kernel call replaced: no card here).
"""

import pytest
import torch

from multimodal_embedding_tpu_torch import ops
from multimodal_embedding_tpu_torch.ops import ssm, ssm_cuda
from multimodal_embedding_tpu_torch.utils.profiling import KERNELS

CHUNK = 64  # csrc/ssm.cu's chunk: wgmma's M
TOL = 2e-5  # of the largest output


def _recurrence(x, dt, a, bm, cm, d, *, bf16_decays=False):
    """S_t = exp(dt_t A) S_{t-1} + (dt_t x_t) B_t^T, y_t = S_t C_t + D x_t,
    token by token in f32."""
    b, t, h, p = x.shape
    state = torch.zeros(b, h, p, bm.shape[-1])
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a)
        if bf16_decays:
            decay = decay.bfloat16().float()
        state = decay[..., None, None] * state + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, i]))
    return torch.stack(ys, dim=1) + d[:, None] * x


def _inputs(t, seed, *, near_one=False, b=2, h=3, p=4, n=8):
    """x, B, C and D normal; dt the softplus of the Mamba-2 initialiser's
    range and A in [-16, -1], or (near_one) dt about 1e-3 and A about -1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=g)
    if near_one:
        dt = 1e-3 * (1 + 0.2 * torch.rand(b, t, h, generator=g))
        a = -(0.8 + 0.4 * torch.rand(h, generator=g))
    else:
        raw = torch.randn(b, t, h, generator=g) * 1.28 + torch.rand(h, generator=g) * 4.6 - 6.9
        dt = torch.nn.functional.softplus(raw)
        a = -1 - 15 * torch.rand(h, generator=g)
    return x, dt, a, torch.randn(b, t, n, generator=g), torch.randn(b, t, n, generator=g), torch.randn(h, generator=g)


def _gap(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("t", [1, 16, 63, 64, 65, 130])
def test_plain_scan_at_the_kernels_chunk_matches_the_recurrence(t):
    args = _inputs(t, seed=t)
    got = ssm.scan_plain(*args, chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert _gap(got, _recurrence(*args)) <= TOL


@pytest.mark.parametrize("t, valid", [(130, 65), (130, 63), (64, 1), (65, 64)])
def test_right_padded_rows_keep_their_outputs(t, valid):
    """Row 1 holds ``valid`` tokens, then padding as the mixer leaves it (x,
    B and C zero, dt as the projection gives it): its valid outputs are the
    row's own, scanned alone, and the batch matches the recurrence."""
    x, dt, a, bm, cm, d = _inputs(t, seed=t + valid)
    for v in (x, bm, cm):
        v[1, valid:] = 0
    got = ssm.scan_plain(x, dt, a, bm, cm, d, chunk=CHUNK)
    alone = ssm.scan_plain(*(v[1:, :valid] for v in (x, dt)), a, bm[1:, :valid], cm[1:, :valid], d, chunk=CHUNK)
    assert _gap(got[1:, :valid], alone) <= TOL
    assert _gap(got, _recurrence(x, dt, a, bm, cm, d)) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_decays_near_one_over_a_page(seed):
    """Decays of about 0.999 carry the state over the whole page; rounding
    them to bf16 (0.99609375) is far outside the limit."""
    args = _inputs(1030, seed=seed, near_one=True, b=1)
    want = _recurrence(*args)
    assert _gap(ssm.scan_plain(*args, chunk=CHUNK), want) <= TOL
    assert _gap(_recurrence(*args, bf16_decays=True), want) > 100 * TOL


@pytest.mark.parametrize("dtype, chunked", [(torch.bfloat16, True), (torch.float32, False),
                                            (torch.float16, False)])
def test_dtype_alone_picks_the_chunked_body(dtype, chunked):
    assert ssm_cuda.uses_chunked(dtype) is chunked


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_launches_are_counted_by_dtype(monkeypatch, dtype):
    """Three launches (the checks and the kernel call replaced: no card
    here): ``ssm_scan`` counts each, ``ssm_scan_chunked`` each bf16 one."""
    monkeypatch.setattr(KERNELS, "counts", {})
    monkeypatch.setattr(ssm_cuda, "_check", lambda *args: None)
    calls = []
    monkeypatch.setattr(ssm_cuda, "_run", lambda *args: calls.append(args[-1].dtype))
    x, dt, a, bm, cm, d = (v.to(dtype) if v.dtype == torch.float32 else v for v in _inputs(5, seed=0))
    for _ in range(3):
        y = ssm_cuda.scan(x, dt, a.float(), bm, cm, d)
        assert y.shape == x.shape and y.dtype == dtype
    counts = ops.launch_counts()
    assert calls == [dtype] * 3
    assert counts["ssm_scan"] == 3 and counts["ssm_scan_chunked"] == (3 if dtype == torch.bfloat16 else 0)
