"""The port's neural CA (models/nca.py, pipelines/nca_train.py,
pipelines/nca_gen.py) against the JAX package's on the CPU.

JAX draws its randomness from threefry keys and the port from one
``torch.Generator``; the parity tests hand the port JAX's own draws through
``_Replay`` (uniform masks, batch indices, rollout lengths, in the order the
port asks for them).  VGG-16 weights are numpy-made and written once with
JAX's ``save_npz_params``, so both packages read one file.  Tolerances are
stated per test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from maua_style_tpu.models import convert as jax_convert
from maua_style_tpu.models import nca as jax_nca
from maua_style_tpu.models.extractor import truncate_spec as jax_truncate_spec
from maua_style_tpu.models.registry import select_model as jax_select_model
from maua_style_tpu.pipelines import nca_gen as jax_gen
from maua_style_tpu.pipelines import nca_train as jax_train
from maua_style_tpu_torch.models import nca
from maua_style_tpu_torch.pipelines import nca_gen, nca_train
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

TWO_LAYERS = ("relu1_1", "relu2_1")


def _nchw(x):
    return torch.from_numpy(np.transpose(np.array(x), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


class _Replay:
    """JAX's draws, handed out in order; each request must match the next
    draw's kind and shape."""

    def __init__(self, items):
        self.items = list(items)

    def _next(self, kind):
        got, value = self.items.pop(0)
        assert got == kind, (got, kind)
        return value

    def uniform(self, shape):
        u = self._next("uniform")
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u.clone()

    def batch(self, pool_size, batch_size):
        idx = self._next("batch")
        assert len(idx) == batch_size and int(idx.max()) < pool_size
        return idx

    def steps(self, low, high):
        n = self._next("steps")
        assert low <= n < high
        return n


def _mask_draws(key, n, shape_nhwc, max_steps=None):
    """JAX rollout's draws: uniforms from ``split(key, max_steps)[:n]``."""
    keys = jax.random.split(key, max_steps or n)
    return [("uniform", _nchw(jax.random.uniform(keys[i], shape_nhwc))) for i in range(n)]


def _jax_params(seed=0, chn=12, w2_scale=0.05):
    p = jax_nca.init_ca_params(chn=chn, seed=seed)
    w2 = np.random.default_rng(seed).standard_normal(p["w2"].shape).astype(np.float32) * w2_scale
    return {**{k: np.asarray(v) for k, v in p.items()}, "w2": w2}


def _jnp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("chn", [5, 12])
def test_perception_matches_jax(chn):
    x = np.random.default_rng(chn).standard_normal((2, 9, 11, chn)).astype(np.float32)
    want = np.asarray(jax_nca.perception(jnp.asarray(x), chn))
    got = _nhwc(nca.perception(_nchw(x)))
    assert got.shape == want.shape == (2, 9, 11, 4 * chn)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("rate", ["scalar", "map"])
def test_ca_step_matches_jax(rate):
    params = _jax_params(1)
    x = np.random.default_rng(2).random((2, 10, 12, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    r = 0.5 if rate == "scalar" else np.random.default_rng(4).random((10, 12)).astype(np.float32)
    want = np.asarray(jax_nca.ca_step(_jnp(params), jnp.asarray(x), key, r if rate == "scalar" else jnp.asarray(r)))
    u = _nchw(jax.random.uniform(key, (2, 10, 12, 1)))
    got = _nhwc(nca.ca_step(nca.ca_params_from_jax(params), _nchw(x), u, r if rate == "scalar" else torch.from_numpy(r)))
    assert np.abs(want - x).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    if rate == "map":  # where the rate is 0 nothing moves
        zero = np.zeros((10, 12), np.float32)
        same = nca.ca_step(nca.ca_params_from_jax(params), _nchw(x), u, torch.from_numpy(zero))
        assert torch.equal(same, _nchw(x))


def test_rollout_matches_jax():
    params = _jax_params(5)
    x = np.random.default_rng(6).random((2, 12, 12, 12)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_nca.rollout(_jnp(params), jnp.asarray(x), key, 8, max_steps=12))
    draws = _Replay(_mask_draws(key, 8, (2, 12, 12, 1), max_steps=12))
    got = _nhwc(nca.rollout(nca.ca_params_from_jax(params), _nchw(x), draws, 8))
    assert not draws.items
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_draws_are_seeded():
    a, b, c = nca.Draws(0, "cpu"), nca.Draws(0, "cpu"), nca.Draws(1, "cpu")
    assert torch.equal(a.uniform((2, 1, 4, 4)), b.uniform((2, 1, 4, 4)))
    assert not torch.equal(a.uniform((2, 1, 4, 4)), c.uniform((2, 1, 4, 4)))
    idx = a.batch(16, 4)
    assert idx.shape == (4,) and len(set(idx.tolist())) == 4 and int(idx.max()) < 16
    assert all(3 <= a.steps(3, 6) < 6 for _ in range(20))


def _vgg16_npz(path, seed=0):
    """He-normal VGG-16 weights up to relu5_1 in the JAX layout, written by
    JAX's ``save_npz_params``."""
    spec = jax_truncate_spec(jax_select_model("vgg16", "max"), jax_train.STYLE_LAYERS)
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for layer in spec.conv_layers:
        shape = (*layer.kernel, cin, layer.out_ch)
        params[layer.name] = {"w": (rng.standard_normal(shape) * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                              "b": (rng.standard_normal(layer.out_ch) * 0.01).astype(np.float32)}
        cin = layer.out_ch
    jax_convert.save_npz_params(params, str(path))
    return str(path)


def test_style_grams_match_jax(tmp_path):
    path = _vgg16_npz(tmp_path / "vgg16.npz")
    imgs = np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32) * 1.4 - 0.2  # unclipped RGB
    want = [np.asarray(g) for g in jax_train._build_style_fn(path)(jnp.asarray(imgs))]
    got = [g.numpy() for g in nca_train._build_style_fn(path, device="cpu")(_nchw(imgs))]
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, c, c) for c in (64, 128, 256, 512, 512)]
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4, _rel(g, w)


def test_loss_and_gradient_match_jax(tmp_path, monkeypatch):
    """The loss of a 3-step rollout and its gradient with respect to w1, b1
    and w2, against ``jax.grad`` of the same composition of JAX's parts."""
    for mod in (jax_train, nca_train):
        monkeypatch.setattr(mod, "STYLE_LAYERS", TWO_LAYERS)
    path = _vgg16_npz(tmp_path / "vgg16.npz")
    rng = np.random.default_rng(9)
    params = _jax_params(10)
    x = rng.random((2, 16, 16, 12)).astype(np.float32) * 0.5
    style = rng.random((1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    calc = jax_train._build_style_fn(path)
    target = [g[0] for g in calc(jnp.asarray(style))]

    def jax_loss(p):
        y = jax_nca.rollout(p, jnp.asarray(x), key, 3, max_steps=4)
        return jax_train.style_loss([g.mean(axis=0) for g in calc(jax_nca.to_rgb(y))], target)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(_jnp(params))

    calc_t = nca_train._build_style_fn(path, device="cpu")
    target_t = [g[0] for g in calc_t(_nchw(style))]
    leaves = {k: v.requires_grad_(True) for k, v in nca.ca_params_from_jax(params).items()}
    y = nca.rollout(leaves, _nchw(x), _Replay(_mask_draws(key, 3, (2, 16, 16, 1), max_steps=4)), 3)
    loss = nca_train.style_loss([g.mean(0) for g in calc_t(nca.to_rgb(y))], target_t)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert _rel(float(loss.detach()), float(want_loss)) <= 1e-4
    got = nca.ca_params_to_jax(grads)
    for k in ("w1", "b1", "w2"):
        assert np.abs(np.asarray(want_grads[k])).max() > 0, k
        assert _rel(got[k], want_grads[k]) <= 1e-4, (k, _rel(got[k], want_grads[k]))


@pytest.mark.parametrize("count", [1999, 2000, 2001, 4000])
def test_normalized_adam_update_matches_optax(count):
    """The schedule reads the update count before the update: the update
    with ``count`` earlier ones runs at 1e-3 · 0.3^(boundaries <= count)."""
    schedule = optax.piecewise_constant_schedule(1e-3, {2000: 0.3, 4000: 0.3})
    assert nca_train.learning_rate(count) == pytest.approx(float(schedule(count)), rel=1e-6)
    rng = np.random.default_rng(count)
    params = _jax_params(0)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    mu = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01 for k, v in params.items()}
    nu = {k: rng.random(v.shape).astype(np.float32) * 1e-4 for k, v in params.items()}

    opt = optax.adam(schedule)
    state = opt.init(_jnp(params))
    adam_state, sched_state = state
    state = (adam_state._replace(count=jnp.asarray(count, jnp.int32), mu=_jnp(mu), nu=_jnp(nu)),
             sched_state._replace(count=jnp.asarray(count, jnp.int32)))
    normed = jax.tree_util.tree_map(lambda g: g / (jnp.linalg.norm(g) + 1e-8), _jnp(grads))
    updates, _ = opt.update(normed, state, _jnp(params))
    want = optax.apply_updates(_jnp(params), updates)

    adam = nca_train.Adam(1.0)
    t = lambda d: nca.ca_params_from_jax(d)  # noqa: E731
    opt_state = {k: {"mu": t(mu)[k], "nu": t(nu)[k], "count": torch.tensor(count)} for k in params}
    got = nca_train.normalized_adam_update(t(params), t(grads), adam, opt_state, count)
    got = nca.ca_params_to_jax(got)
    for k in params:
        assert _rel(got[k] - params[k], np.asarray(want[k]) - params[k]) <= 1e-4, k
        assert int(opt_state[k]["count"]) == count + 1


def _jax_train_draws(seed, n_steps, pool_size, batch_size, grid, min_rollout, max_rollout):
    """The draws JAX's ``train`` makes, in the order the port asks."""
    items = []
    rng = jax.random.PRNGKey(seed)
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        k_batch, k_loss = jax.random.split(sub)
        idx = jax.random.choice(k_batch, pool_size, (batch_size,), replace=False)
        k_roll, k_steps = jax.random.split(k_loss)
        n = int(jax.random.randint(k_steps, (), min_rollout, max_rollout))
        items += [("batch", torch.from_numpy(np.asarray(idx)).long()), ("steps", n)]
        items += _mask_draws(k_roll, n, (batch_size, grid, grid, 1), max_steps=max_rollout)
    return items


def _style_png(path, seed=0, size=(40, 56)):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(str(path))
    return str(path)


@pytest.fixture
def _jax_init_params(monkeypatch):
    """The port's trainer starts from JAX's initial parameters (threefry
    draws)."""
    def init(chn=12, hidden_n=96, seed=0, *, device):
        return {k: v.to(device) for k, v in nca.ca_params_from_jax(jax_nca.init_ca_params(chn, hidden_n, seed)).items()}

    monkeypatch.setattr(nca, "init_ca_params", init)


@pytest.mark.usefixtures("_jax_init_params")
def test_two_train_steps_match_jax(tmp_path, monkeypatch, capsys):
    for mod in (jax_train, nca_train):
        monkeypatch.setattr(mod, "STYLE_LAYERS", TWO_LAYERS)
    path = _vgg16_npz(tmp_path / "vgg16.npz")
    style = _style_png(tmp_path / "style.png")
    kw = dict(n_steps=2, pool_size=8, batch_size=2, grid_size=16, seed=3, log_every=1, save_every=2,
              model_file=path, min_rollout=2, max_rollout=4)

    jax_params, jax_log = jax_train.train(style, str(tmp_path / "jax"), **kw)
    jax_out = capsys.readouterr().out
    draws = _Replay(_jax_train_draws(3, 2, 8, 2, 16, 2, 4))
    params, log = nca_train.train(style, str(tmp_path / "port"), device="cpu", draws=draws, **kw)
    out = capsys.readouterr().out
    assert not draws.items

    assert len(log) == len(jax_log) == 2 and np.isfinite(log).all()
    np.testing.assert_allclose(log, jax_log, rtol=1e-4)
    assert [l.split("lr:")[1] for l in out.splitlines() if "lr:" in l] == [
        l.split("lr:")[1] for l in jax_out.splitlines() if "lr:" in l]
    got = nca.ca_params_to_jax(params)
    for k in ("w1", "b1", "w2"):
        assert _rel(got[k], jax_params[k]) <= 1e-4, k
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == ["style_2.npz", "style_2.png"]
    with np.load(tmp_path / "jax" / "style_2.npz") as want, np.load(tmp_path / "port" / "style_2.npz") as have:
        assert sorted(want.files) == sorted(have.files)
        for k in want.files:
            assert have[k].shape == want[k].shape and _rel(have[k], want[k]) <= 1e-4, k


def test_nonfinite_loss_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nca_train, "STYLE_LAYERS", TWO_LAYERS)
    monkeypatch.setattr(nca_train, "style_loss", lambda gx, gy: sum(g.sum() for g in gx) * float("nan"))
    with pytest.raises(FloatingPointError, match="step 1"):
        nca_train.train(_style_png(tmp_path / "s.png"), str(tmp_path / "o"), n_steps=2, pool_size=4, batch_size=2,
                        grid_size=8, log_every=0, save_every=0, min_rollout=1, max_rollout=2, device="cpu",
                        allow_random_weights=True)


def _capture_frames(monkeypatch, module):
    frames = {}

    def capture(frames01, path, fps=30.0):
        frames[os.path.basename(path)] = np.stack(frames01)

    monkeypatch.setattr(module, "_write_video", capture)
    return frames


def _gen_draws(kind, num_frames, params_count=1, w=16):
    """JAX's generation draws: PRNGKey(0), split once per CA step."""
    key = jax.random.PRNGKey(0)
    items = []
    if kind == "grid":
        items.append(("uniform", _nchw(jax.random.uniform(key, (1, 512, w * params_count + 2, 12)))))
        shape, steps = (1, 512, w + 2, 1), [8 * params_count] * num_frames
    elif kind == "evolution":
        shape, steps = (1, 16, 16, 1), [min(2 ** (k // 30), 32) for k in range(num_frames)]
    else:
        h, wd = jax_gen.text_mask("A").shape
        shape, steps = (1, h, wd, 1), [min(int(2 ** (k / 30)), 32) for k in range(num_frames)]
    for _ in range(sum(steps)):
        key, sub = jax.random.split(key)
        items.append(("uniform", _nchw(jax.random.uniform(sub, shape))))
    return items


@pytest.mark.parametrize("kind", ["evolution", "grid", "text"])
def test_generation_matches_jax(kind, tmp_path, monkeypatch):
    """The three videos at tests/test_nca.py's sizes, the port fed JAX's
    draws: every frame within 1e-4."""
    params = _jax_params(12, w2_scale=0.02)
    want_frames = _capture_frames(monkeypatch, jax_gen)
    got_frames = _capture_frames(monkeypatch, nca_gen)
    p = nca.ca_params_from_jax(params)
    if kind == "grid":
        paths = [str(tmp_path / "s_1.npz"), str(tmp_path / "s_2.npz")]
        jax_nca.save_ca(_jnp(params), paths[0])
        jax_nca.save_ca(_jnp(_jax_params(13, w2_scale=0.02)), paths[1])
        jax_gen.checkpoint_grid_video(paths, "v.mp4", num_frames=2, w=16)
        nca_gen.checkpoint_grid_video(paths, "v.mp4", num_frames=2, w=16, device="cpu",
                                      draws=_Replay(_gen_draws("grid", 2, params_count=2)))
    elif kind == "evolution":
        jax_gen.evolution_video(_jnp(params), "v.mp4", num_frames=4, size=16, zoom=1)
        nca_gen.evolution_video(p, "v.mp4", num_frames=4, size=16, zoom=1, draws=_Replay(_gen_draws("evolution", 4)))
    else:
        jax_gen.text_video(_jnp(params), "v.mp4", "A", num_frames=2)
        nca_gen.text_video(p, "v.mp4", "A", num_frames=2, draws=_Replay(_gen_draws("text", 2)))
    want, got = want_frames["v.mp4"], got_frames["v.mp4"]
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_checkpoints_load_in_both_packages(tmp_path):
    jax_params = jax_nca.init_ca_params(chn=12, seed=3)
    jax_nca.save_ca(jax_params, str(tmp_path / "j.npz"))
    loaded = nca.load_ca(str(tmp_path / "j.npz"), "cpu")
    assert {k: tuple(v.shape) for k, v in loaded.items()} == {"w1": (96, 48, 1, 1), "b1": (96,), "w2": (12, 96, 1, 1)}
    for k, v in nca.ca_params_to_jax(loaded).items():
        np.testing.assert_array_equal(v, np.asarray(jax_params[k]))

    port_params = nca.init_ca_params(chn=12, seed=4, device="cpu")
    port_params["w2"] = torch.randn(port_params["w2"].shape, generator=torch.Generator().manual_seed(0))
    nca.save_ca(port_params, str(tmp_path / "p.npz"))
    back = jax_nca.load_ca(str(tmp_path / "p.npz"))
    assert {k: v.shape for k, v in back.items()} == {"w1": (1, 1, 48, 96), "b1": (96,), "w2": (1, 1, 96, 12)}
    for k, v in nca.ca_params_from_jax({k: np.asarray(v) for k, v in back.items()}).items():
        assert torch.equal(v, port_params[k]), k


def test_init_matches_the_reference_init():
    p = nca.init_ca_params(chn=12, seed=0, device="cpu")
    bound = 1.0 / np.sqrt(48)
    assert p["w1"].shape == (96, 48, 1, 1) and p["b1"].shape == (96,) and p["w2"].shape == (12, 96, 1, 1)
    assert float(p["w1"].abs().max()) <= bound and float(p["b1"].abs().max()) <= bound
    assert float(p["b1"].abs().min()) > 0 and not torch.any(p["w2"])
    assert torch.equal(p["w1"], nca.init_ca_params(chn=12, seed=0, device="cpu")["w1"])


def test_clis_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both CLIs with --gpu c; generation writes the JAX CLI's artifact
    names (here the .npy stacks: no ffmpeg); without CUDA and without
    --gpu c both raise."""
    monkeypatch.setattr(nca_train, "STYLE_LAYERS", TWO_LAYERS)
    style = _style_png(tmp_path / "tex.png")
    out = tmp_path / "out"
    nca_train.main([style, str(out), "--n_steps", "2", "--pool_size", "8", "--grid_size", "16",
                    "--allow_random_weights", "--gpu", "c"])
    assert "step_n:     2" in capsys.readouterr().out

    dirs = {}
    for pkg, gen in (("jax", jax_gen), ("port", nca_gen)):
        d = tmp_path / pkg
        d.mkdir()
        for n in range(1, 6):  # five checkpoints: the grid takes the middle one
            jax_nca.save_ca(_jnp(_jax_params(n, w2_scale=0.01)), str(d / f"tex_{n * 1500}.npz"))
        gen.main([style, str(d), "--num_frames", "2", "--text", "A"] + (["--gpu", "c"] if pkg == "port" else []))
        dirs[pkg] = sorted(os.listdir(d))
    assert dirs["port"] == dirs["jax"]
    assert {"tex_7500.npy", "tex_checkgrid.npy", "tex-7500-wav.npy"} <= set(dirs["port"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--gpu c"):
        nca_train.main([style, str(out)])
    with pytest.raises(RuntimeError, match="--gpu c"):
        nca_gen.main([style, str(tmp_path / "port")])
