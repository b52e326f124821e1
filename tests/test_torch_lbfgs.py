"""The port's L-BFGS (both methods) step for step against the JAX package's
lbfgs and torch.optim.LBFGS, at the tolerances of tests/test_lbfgs.py, and
its Adam against optax.adam."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_style_tpu.engine.lbfgs import lbfgs as jax_lbfgs
from maua_style_tpu_torch.engine.lbfgs import LBFGS, Adam
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _quadratic(seed, n, shift, with_b):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, n).astype(np.float32)
    h = a @ a.T + shift * np.eye(n, dtype=np.float32)
    b = rng.rand(n).astype(np.float32) if with_b else np.zeros(n, np.float32)
    x0 = rng.rand(n).astype(np.float32)
    th, tb = torch.from_numpy(h), torch.from_numpy(b)
    jh, jb = jnp.asarray(h), jnp.asarray(b)
    return x0, (lambda p: 0.5 * p @ th @ p - tb @ p), (lambda p: 0.5 * p @ jh @ p - jb @ p)


def _nonconvex():
    x0 = (np.random.RandomState(1).rand(8).astype(np.float32) - 0.5) * 2
    f = lambda p: (p**4).sum() - (p**2).sum() + 0.3 * p.sum()
    return x0, f, f


# (problem, iterations, lr, history, tolerance) — tests/test_lbfgs.py:46-85
CASES = {
    "quadratic": (lambda: _quadratic(0, 12, 0.5, True), 25, 0.9, 5, 1e-3),
    "nonconvex": (_nonconvex, 30, 0.5, 7, 2e-3),
    "overflow": (lambda: _quadratic(2, 6, 1.0, False), 20, 1.0, 3, 1e-3),
}


def run_port(x0, f, n_iters, lr, history, method, history_dtype=None):
    opt = LBFGS(lr, history, method, history_dtype)
    p = torch.from_numpy(x0.copy())
    state = opt.init(p)
    for _ in range(n_iters):
        q = p.clone().requires_grad_(True)
        f(q).backward()
        upd, state = opt.update(q.grad, state)
        p = p + upd
    return p.numpy()


def run_jax(x0, f, n_iters, lr, history, method):
    opt = jax_lbfgs(lr, history, method=method)
    p = jnp.asarray(x0.copy())
    st = opt.init(p)

    def step(carry, _):
        p, st = carry
        upd, st = opt.update(jax.grad(f)(p), st, p)
        return (optax.apply_updates(p, upd), st), None

    (p, _), _ = jax.lax.scan(step, (p, st), length=n_iters)
    return np.asarray(p)


def run_torch(x0, f, n_iters, lr, history):
    p = torch.from_numpy(x0.copy()).requires_grad_(True)
    opt = torch.optim.LBFGS([p], lr=lr, max_iter=n_iters, history_size=history, tolerance_change=-1.0, tolerance_grad=-1.0)

    def closure():
        opt.zero_grad()
        loss = f(p)
        loss.backward()
        return loss

    opt.step(closure)
    return p.detach().numpy()


@pytest.mark.parametrize("method", ["compact", "two_loop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lbfgs_matches_jax_and_torch(method, case):
    make, n_iters, lr, history, tol = CASES[case]
    x0, tf, jf = make()
    got = run_port(x0, tf, n_iters, lr, history, method)
    np.testing.assert_allclose(got, run_jax(x0, jf, n_iters, lr, history, method), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, run_torch(x0, tf, n_iters, lr, history), atol=tol, rtol=tol)


def test_lbfgs_methods_agree_and_state_stays_on_device():
    x0, tf, _ = _quadratic(5, 20, 1.0, True)
    a = run_port(x0, tf, 15, 1.0, 4, "compact")
    b = run_port(x0, tf, 15, 1.0, 4, "two_loop")
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    state = LBFGS(1.0, 4).init(torch.zeros(3, 5))
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    assert state["s_hist"].shape == (4, 15) and state["step"].dtype == torch.int64


def test_lbfgs_bf16_history_converges():
    """bf16 history storage with f32 dots reaches the optimum of a
    well-conditioned quadratic, as the JAX package's serving config."""
    rng = np.random.RandomState(4)
    n = 64
    x0 = rng.rand(n).astype(np.float32)
    a = rng.rand(n, n).astype(np.float32)
    h = torch.from_numpy(a @ a.T + np.eye(n, dtype=np.float32) * n)
    f = lambda p: 0.5 * p @ h @ p
    got32 = run_port(x0, f, 30, 1.0, 10, "compact")
    got16 = run_port(x0, f, 30, 1.0, 10, "compact", torch.bfloat16)
    assert float(np.abs(got32).max()) < 1e-4
    assert float(np.abs(got16).max()) < 1e-2
    assert LBFGS(1.0, 10, history_dtype=torch.bfloat16).init(torch.zeros(n))["s_hist"].dtype == torch.bfloat16


def test_adam_matches_optax():
    rng = np.random.RandomState(3)
    n = 10
    x0 = rng.rand(n).astype(np.float32)
    a = rng.rand(n, n).astype(np.float32)
    h = a @ a.T + np.eye(n, dtype=np.float32)
    th, jh = torch.from_numpy(h), jnp.asarray(h)

    opt = Adam(0.1)
    p = torch.from_numpy(x0.copy())
    st = opt.init(p)
    oj = optax.adam(0.1)
    pj = jnp.asarray(x0.copy())
    sj = oj.init(pj)
    for _ in range(50):
        upd, st = opt.update(th @ p, st)
        p = p + upd
        uj, sj = oj.update(jax.grad(lambda q: 0.5 * q @ jh @ q)(pj), sj, pj)
        pj = optax.apply_updates(pj, uj)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-4, rtol=1e-4)
