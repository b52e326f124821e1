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
from maua_style_tpu.ops.pallas_gram import gram_nhwc, gram_pallas
from maua_style_tpu_torch.ops import gram as G


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
    before = G.gram.launches
    f = torch.randn(2, 5, 40)
    torch.testing.assert_close(G.gram(f), G.gram_reference(f), rtol=0, atol=0)
    G.batch_gram(torch.randn(1, 3, 4, 5, requires_grad=True)).sum().backward()
    assert G.gram.launches == before


def test_gram_matrix_and_bf16_reference():
    x = torch.randn(6, 5, 7)
    torch.testing.assert_close(G.gram_matrix(x), G.batch_gram(x[None])[0], rtol=0, atol=0)
    xb = x.to(torch.bfloat16)
    g = G.batch_gram(xb[None])
    assert g.dtype == torch.float32  # bf16 activations, f32 statistics
    f = xb.float().reshape(6, -1)
    torch.testing.assert_close(g[0], f @ f.T, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("b,c,n,sms", [(1, 64, 1048576, 132), (1, 512, 4096, 132), (2, 128, 131044, 132),
                                      (1, 70, 300, 132), (3, 1000, 37, 132), (1, 64, 1, 8)])
def test_gram_splits_cover_n_exactly(b, c, n, sms):
    pairs, splits, chunk = G.gram_splits(b, c, n, sms)
    tiles = -(-c // 64)
    assert pairs == tiles * (tiles + 1) // 2
    assert chunk % 32 == 0 and splits >= 1
    assert (splits - 1) * chunk < n <= splits * chunk  # no empty split, nothing left over
    assert splits < 65536  # gridDim.y
