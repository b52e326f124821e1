"""The Gram: the port's batch_gram against maua_style_tpu.ops.gram in values
and gradients, its plain version against the Pallas kernel in interpret
mode, and the Python around the CUDA kernel (tests/test_torch_gram_cuda.py
runs the kernel itself on a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.ops.gram import batch_gram as jax_batch_gram
from maua_style_tpu.ops.gram import video_gram as jax_video_gram
from maua_style_tpu.ops.pallas_gram import gram_nhwc, gram_pallas
from maua_style_tpu_torch import trace
from maua_style_tpu_torch.ops import gram as G
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("shape", [(1, 9, 11, 33), (2, 16, 12, 64)])
def test_batch_gram_values_and_grads_match_jax(use_covariance, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    w = rng.normal(size=(shape[0], shape[3], shape[3])).astype(np.float32)

    want, vjp = jax.vjp(lambda a: jax_batch_gram(a, use_covariance), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(w))

    xt = _nchw(x).requires_grad_(True)
    got = G.batch_gram(xt, use_covariance)
    (got * torch.from_numpy(w)).sum().backward()
    # f32 sums over H*W in another order: relative 1e-5 of the largest entry
    tol = 1e-5 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=0)
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[3], shape[3])
    want_dx = np.transpose(np.asarray(want_dx), (0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-5 * float(np.abs(want_dx).max()), rtol=0)


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("shape", [(3, 9, 11, 8), (4, 6, 5, 16), (1, 7, 7, 5)])
def test_video_gram_values_and_grads_match_jax(use_covariance, shape):
    """The whole-window Gram: (T, H, W, C) -> (T·C, T·C) in JAX, the
    (1, T·C, H·W) view of NCHW here; the gradient against JAX's custom VJP."""
    t, c = shape[0], shape[3]
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    w = rng.normal(size=(t * c, t * c)).astype(np.float32)

    want, vjp = jax.vjp(lambda a: jax_video_gram(a, use_covariance), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(w))

    xt = _nchw(x).requires_grad_(True)
    got = G.video_gram(xt, use_covariance)
    assert got.dtype == torch.float32 and got.shape == (t * c, t * c)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    want_dx = np.transpose(np.asarray(want_dx), (0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-4 * float(np.abs(want_dx).max()), rtol=0)


def test_video_gram_is_batch_gram_of_the_row_view():
    """Frame-major rows: block (a, b) of the video Gram is frame a's
    channels against frame b's, and each diagonal block is that frame's
    own Gram; the CPU path launches no kernel."""
    before = trace.counter("gram.launches")
    x = torch.randn(3, 4, 5, 6)
    v = G.video_gram(x)
    f = x.reshape(3, 4, 30)
    for a in range(3):
        for b in range(3):
            torch.testing.assert_close(v[4 * a : 4 * a + 4, 4 * b : 4 * b + 4], f[a] @ f[b].T, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(G.video_gram(x[:1]), G.batch_gram(x[:1])[0], rtol=0, atol=0)
    assert trace.counter("gram.launches") == before


def test_gram_reference_matches_pallas_interpret():
    """The plain version against the TPU kernel itself, run in Pallas
    interpret mode as tests/test_flow.py runs it."""
    rng = np.random.default_rng(1)
    f = rng.random((300, 70)).astype(np.float32)  # unaligned N and C
    want = np.asarray(gram_pallas(jnp.asarray(f), True))
    got = G.gram_reference(torch.from_numpy(np.ascontiguousarray(f.T))[None])[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)

    a = rng.random((2, 9, 11, 33)).astype(np.float32)
    want = np.asarray(gram_nhwc(jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(G.batch_gram(_nchw(a)).numpy(), want, atol=1e-3, rtol=1e-4)

    # backward: f (g + gᵀ), as the Pallas custom VJP
    fj = jnp.asarray(f)
    g_want = np.asarray(jax.grad(lambda x: jnp.sum(gram_pallas(x, True) * 2.0))(fj))
    ft = torch.from_numpy(np.ascontiguousarray(f.T))[None].requires_grad_(True)
    (G._GramFn.apply(ft) * 2.0).sum().backward()
    np.testing.assert_allclose(ft.grad[0].numpy().T, g_want, atol=1e-3, rtol=1e-3)


def test_cpu_tensor_uses_plain_version_and_counts_nothing():
    before = trace.counter("gram.launches")
    f = torch.randn(2, 5, 40)
    torch.testing.assert_close(G.gram(f), G.gram_reference(f), rtol=0, atol=0)
    G.batch_gram(torch.randn(1, 3, 4, 5, requires_grad=True)).sum().backward()
    assert trace.counter("gram.launches") == before


def test_gram_matrix_and_bf16_reference():
    x = torch.randn(6, 5, 7)
    torch.testing.assert_close(G.gram_matrix(x), G.batch_gram(x[None])[0], rtol=0, atol=0)
    xb = x.to(torch.bfloat16)
    g = G.batch_gram(xb[None])
    assert g.dtype == torch.float32  # bf16 activations, f32 statistics
    f = xb.float().reshape(6, -1)
    torch.testing.assert_close(g[0], f @ f.T, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,c,n,sms", [(1, 64, 1048576, 132), (1, 512, 4096, 132), (2, 128, 131044, 132),
                                      (1, 70, 300, 132), (3, 1000, 37, 132), (1, 64, 1, 8),
                                      (1, 256, 32761, 132), (1, 512, 2025, 132), (1, 64, 16777216, 132)])
def test_gram_splits_cover_n_exactly(b, c, n, sms, bf16):
    sp = G.gram_splits(b, c, n, sms, bf16)
    assert sp.tile == (64 if c <= 64 else 128)
    tiles = -(-c // sp.tile)
    assert sp.pairs == tiles * (tiles + 1) // 2
    cuts = [(sp.splits_diag, sp.chunk_diag)] + ([(sp.splits_off, sp.chunk_off)] if tiles > 1 else [])
    for splits, chunk in cuts:
        # whole stages (32 f32 or 64 bf16 positions), so only a pair's last split is ragged
        assert chunk % 64 == 0 and splits >= 1
        assert (splits - 1) * chunk < n <= splits * chunk  # no empty split, nothing left over
        assert splits < 65536  # gridDim.y
    if tiles > 1:  # a diagonal pair's block sums more positions: it does less work per position
        assert sp.chunk_diag >= sp.chunk_off
    resident = 2 if sp.tile == 64 else 1  # blocks an SM holds
    blocks = b * (tiles * sp.splits_diag + (sp.pairs - tiles) * sp.splits_off)
    assert blocks == b * sp.pairs or blocks <= 4 * resident * sms  # at most four waves


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the TF32 value the tensor
    cores read of an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_lo(x: torch.Tensor) -> torch.Tensor:
    """x - hi (exact in f32) rounded to the nearest TF32, ties away from zero,
    by integer arithmetic on the float bits: add half a TF32 ulp to the
    magnitude bits and clear the 13 low bits."""
    bits = (x - _tf32_hi(x)).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("c,n,signed", [(8, 100, True), (64, 4096, False), (70, 333, True), (130, 2025, False)])
def test_3xtf32_split_keeps_f32_accuracy(c, n, signed):
    """The error model csrc/gram.cu relies on for f32 inputs: hi = x
    truncated to TF32, lo = tf32(x - hi), G ~ lo·hiᵀ + hi·loᵀ + hi·hiᵀ (the
    products summed exactly here, in f64) is within 1e-6 of the exact Gram
    relative to its largest entry, and nearer to it than one TF32 product
    (hi·hiᵀ).  A diagonal tile's form, S = lo·hiᵀ + (hi/2)·hiᵀ and
    G = S + Sᵀ, is the same sum."""
    rng = np.random.default_rng(c * n)
    x = rng.normal(0.0, 3.0, (c, n)).astype(np.float32)
    if not signed:
        x = np.maximum(x, 0.0)  # relu activations
    f = torch.from_numpy(x)
    hi, lo = _tf32_hi(f), _tf32_lo(f)
    # both halves are TF32 values, and the split is exact to 2^-21 of each |x|
    assert not ((hi.view(torch.int32) & 0x1FFF).any() or (lo.view(torch.int32) & 0x1FFF).any())
    h, l, x64 = hi.double(), lo.double(), f.double()
    assert bool(((x64 - h - l).abs() <= 2.0**-21 * x64.abs()).all())
    exact = x64 @ x64.T
    scale = float(exact.abs().max())
    three = l @ h.T + h @ l.T + h @ h.T
    err3 = float((three - exact).abs().max()) / scale
    err1 = float((h @ h.T - exact).abs().max()) / scale
    assert err3 <= 1e-6
    assert err3 < err1
    s = l @ h.T + (0.5 * h) @ h.T
    torch.testing.assert_close(s + s.T, three, rtol=1e-12, atol=1e-12 * scale)
