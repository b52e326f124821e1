"""The port's custom-gradient ops (``ops/grads.py``) and cutouts
(``ops/cutouts.py``) against the JAX package's on the CPU.

Bars: the grads' forwards and backwards within 1e-6 (elementwise float32
arithmetic in the same order; the spherical distance within 1e-5, an
arcsin of a norm); the resample matrices and stratified sizes exactly equal
(the same numpy code); ``make_cutouts`` from JAX's own draws (the phase and
offsets its threefry key gives) within 1e-5, output and input gradient
(two float32 products per slot, summed in another order); the bilinear
method from JAX's three uniform draws within 1e-5, the output absolute,
the input gradient relative to its largest element (a pixel's gradient
sums up to cutn · (cut_size / size)² weighted taps: JAX's own float32
gradient lies 1.7e-5 from a float64 one at max|g| ≈ 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.ops import cutouts as jax_cutouts
from maua_style_tpu.ops import grads as jax_grads
from maua_style_tpu_torch.ops import cutouts, grads
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


class _Replay:
    """JAX's cutout draws, handed out in order."""

    def __init__(self, items):
        self.items = list(items)

    def cutouts(self, cutn, phases):
        phase, offs = self.items.pop(0)
        assert offs.shape == (cutn, 2) and 0 <= phase < phases
        return phase, offs

    def bilinear(self, cutn):
        u = self.items.pop(0)
        assert len(u) == 3 and all(a.shape == (cutn,) for a in u)
        return u


def jax_cutout_draw(key, cutn, phases):
    """The (phase, offsets) JAX's make_cutouts derives from ``key``
    (cutouts.py:126-127, 148)."""
    k_phase, k_offs = jax.random.split(key)
    offs = np.asarray(jax.random.uniform(k_offs, (cutn, 2)))
    phase = int(jax.random.randint(k_phase, (), 0, phases)) if phases > 1 else 0
    return phase, offs


def jax_bilinear_draw(key, cutn):
    """The (sizes, x offsets, y offsets) uniforms JAX's bilinear cutouts
    derive from ``key`` (cutouts.py:161-167)."""
    return tuple(np.asarray(jax.random.uniform(k, (cutn,))) for k in jax.random.split(key, 3))


# ---------------------------------------------------------------------------
# grads


@pytest.mark.parametrize("fwd_shape,bwd_shape", [((2, 3), (2, 3)), ((2, 3), (1, 3)), ((4, 2, 3), (2, 1)),
                                                 ((1, 8, 5, 4), (1, 1, 5, 4))])
def test_replace_grad(fwd_shape, bwd_shape):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(fwd_shape).astype(np.float32)
    b = rng.standard_normal(bwd_shape).astype(np.float32)
    cot = rng.standard_normal(fwd_shape).astype(np.float32)

    def f(a, b):
        return jnp.sum(jax_grads.replace_grad(a * 2, b * 3) * cot)

    want_out = np.asarray(jax_grads.replace_grad(jnp.asarray(a), jnp.asarray(b)))
    ga_want, gb_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a, True), _t(b, True)
    out = grads.replace_grad(at * 2, bt * 3)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(grads.replace_grad(_t(a), _t(b)).numpy(), want_out, atol=1e-6)
    assert at.grad is None and not np.any(np.asarray(ga_want))  # no gradient to x_forward
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_want), atol=1e-6)


def test_clamp_with_grad():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.linspace(-2, 2, 41), rng.standard_normal(20)]).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want_out = np.asarray(jax_grads.clamp_with_grad(jnp.asarray(x), 0.0, 1.0))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax_grads.clamp_with_grad(v, 0.0, 1.0) * cot))(jnp.asarray(x)))
    xt = _t(x, True)
    out = grads.clamp_with_grad(xt, 0.0, 1.0)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-6)
    assert np.any(want_g == 0) and np.any(want_g != 0)  # both branches taken


@pytest.mark.parametrize("yshape", [(6, 16), (1, 16)])
def test_spherical_dist(yshape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    y = rng.standard_normal(yshape).astype(np.float32)
    want = np.asarray(jax_grads.spherical_dist(jnp.asarray(x), jnp.asarray(y)))
    want_g = np.asarray(jax.grad(lambda v: jax_grads.spherical_dist(v, jnp.asarray(y)).mean())(jnp.asarray(x)))
    xt = _t(x, True)
    got = grads.spherical_dist(xt, _t(y))
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-5)


# ---------------------------------------------------------------------------
# cutouts


@pytest.mark.parametrize("src,dst", [(64, 32), (100, 32), (33, 32), (32, 32), (20, 32), (256, 224), (240, 224)])
def test_resample_matrices_equal(src, dst):
    np.testing.assert_array_equal(cutouts.lanczos_prefilter_matrix(src, dst), jax_cutouts.lanczos_prefilter_matrix(src, dst))
    np.testing.assert_array_equal(cutouts.bicubic_matrix(dst, src), jax_cutouts.bicubic_matrix(dst, src))
    np.testing.assert_array_equal(cutouts.resample_matrix(src, dst), jax_cutouts.resample_matrix(src, dst))


@pytest.mark.parametrize("h,w,cut,cutn,cut_pow,phase", [(256, 256, 224, 64, 1.0, 0.125), (48, 64, 16, 8, 1.0, 0.875),
                                                        (35, 33, 32, 4, 0.5, 0.5), (20, 30, 32, 5, 2.0, 0.375)])
def test_stratified_sizes_equal(h, w, cut, cutn, cut_pow, phase):
    assert cutouts.stratified_sizes(h, w, cut, cutn, cut_pow, phase) == \
        jax_cutouts.stratified_sizes(h, w, cut, cutn, cut_pow, phase)


@pytest.mark.parametrize("hw,cut,cutn,phases,seed", [((48, 64), 16, 8, 4, 0), ((35, 33), 32, 4, 4, 1),
                                                     ((40, 40), 24, 6, 1, 2), ((30, 52), 16, 5, 3, 3),
                                                     ((20, 30), 32, 4, 4, 4)])
def test_make_cutouts_on_jax_draws(hw, cut, cutn, phases, seed):
    """Output and input gradient within 1e-5 of JAX's make_cutouts on the
    same key, replayed as (phase, offsets).  (20, 30) with cuts of 32: a
    cut larger than the canvas's short side, every slot min(h, w) upsampled
    (RN50x4's 288 on a 256² canvas)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.random((1, h, w, 3)).astype(np.float32)
    cot = rng.standard_normal((cutn, cut, cut, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)

    def f(xj):
        return jax_cutouts.make_cutouts(key, xj, cut_size=cut, cutn=cutn, phases=phases)

    want = np.asarray(f(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda xj: jnp.sum(f(xj) * cot))(jnp.asarray(x)))

    draws = _Replay([jax_cutout_draw(key, cutn, phases)])
    xt = _t(np.transpose(x, (0, 3, 1, 2)), True)
    got = cutouts.make_cutouts(xt, cut, cutn, draws, phases=phases)
    assert not draws.items and got.shape == (cutn, 3, cut, cut)
    (got * _t(np.transpose(cot, (0, 3, 1, 2)))).sum().backward()
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), want_g, atol=1e-5)
    assert float(got.detach().min()) >= 0.0 and float(got.detach().max()) <= 1.0


@pytest.mark.parametrize("hw,cut,cutn,cut_pow,seed", [((48, 64), 16, 8, 1.0, 0), ((35, 33), 24, 4, 0.5, 1),
                                                      ((20, 30), 32, 4, 1.0, 2), ((30, 52), 16, 5, 2.0, 3)])
def test_bilinear_cutouts_on_jax_draws(hw, cut, cutn, cut_pow, seed):
    """``method="bilinear"``: output and input gradient within 1e-5 of
    JAX's on the same key, replayed as its three uniform draws; (20, 30)
    with cuts of 32 is a cut larger than the canvas."""
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.random((1, h, w, 3)).astype(np.float32)
    cot = rng.standard_normal((cutn, cut, cut, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)

    def f(xj):
        return jax_cutouts.make_cutouts(key, xj, cut_size=cut, cutn=cutn, cut_pow=cut_pow, method="bilinear")

    want = np.asarray(f(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda xj: jnp.sum(f(xj) * cot))(jnp.asarray(x)))

    draws = _Replay([jax_bilinear_draw(key, cutn)])
    xt = _t(np.transpose(x, (0, 3, 1, 2)), True)
    got = cutouts.make_cutouts(xt, cut, cutn, draws, cut_pow=cut_pow, method="bilinear")
    assert not draws.items and got.shape == (cutn, 3, cut, cut)
    (got * _t(np.transpose(cot, (0, 3, 1, 2)))).sum().backward()
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, atol=1e-5)
    g = xt.grad.numpy().transpose(0, 2, 3, 1)
    assert np.abs(g - want_g).max() <= 1e-5 * np.abs(want_g).max(), (np.abs(g - want_g).max(), np.abs(want_g).max())


def test_cutout_draws_seeded():
    a, b, c = cutouts.CutoutDraws(0), cutouts.CutoutDraws(0), cutouts.CutoutDraws(1)
    pa, oa = a.cutouts(8, 4)
    pb, ob = b.cutouts(8, 4)
    _, oc = c.cutouts(8, 4)
    assert pa == pb and 0 <= pa < 4 and oa.dtype == np.float32 and oa.shape == (8, 2)
    np.testing.assert_array_equal(oa, ob)
    assert not np.array_equal(oa, oc)
    assert 0.0 <= oa.min() and oa.max() < 1.0
    # the next call draws anew
    assert not np.array_equal(a.cutouts(8, 4)[1], oa)
    u = a.bilinear(8)
    assert len(u) == 3 and all(v.dtype == np.float32 and v.shape == (8,) and 0 <= v.min() and v.max() < 1 for v in u)
    b.cutouts(8, 4)  # b catches up with a: the same generator state, the same draws
    np.testing.assert_array_equal(np.stack(u), np.stack(b.bilinear(8)))
