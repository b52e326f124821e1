"""img_vid's windows on "frames", "space" and "frames×space" meshes (the
port's ``parallel.window_shares``, ``spatial.WindowLayout``,
``ops.gram.banded_video_gram`` / ``video_gram_blocks`` /
``shared_video_gram`` and ``losses.evaluate_window_losses``), on meshes of
repeated CPU entries: the whole-window Gram of shares and bands against
``video_gram`` (f32, both covariance modes), windowed runs against JAX's
GSPMD engine on the suite's virtual CPU devices (JAX
tests/test_parallel.py:92-114) and against the port's unsharded runs,
L-BFGS windows, the frozen split against the masked runner, run-state
checkpoints across layouts, a 1-frame pastiche, the style CLI against
JAX's with the same ``--mesh``, and similarity's jobs on a "space" mesh.

Shares and bands sum Grams and convolutions in another order than the
whole window (1e-7), so one run is held tightly over a few iterations
(ROADMAP "Banded against unbanded runs")."""

import importlib
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from maua_style_tpu import style as jax_style
from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.losses import LossConfig as JaxLossConfig
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu.parallel import build_mesh as jax_build_mesh
from maua_style_tpu_torch import config
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine import optimize as optimize_module
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import init_params, registry, select_model
from maua_style_tpu_torch.models.convert import params_from_jax
from maua_style_tpu_torch.ops.gram import banded_video_gram, shared_video_gram, video_gram
from maua_style_tpu_torch.parallel import build_mesh, sharding_for, spatial, window_shares
from test_torch_img_img import _assert_u8_drift
from test_torch_img_vid import NARROW, _u8_drift
from test_torch_similarity import _dataset
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

jax_img_vid = importlib.import_module("maua_style_tpu.pipelines.img_vid")
torch_img_vid = importlib.import_module("maua_style_tpu_torch.pipelines.img_vid")

CPU = torch.device("cpu")
FRAMES2, FRAMES4, SPACE2 = [("frames", 2)], [("frames", 4)], [("space", 2)]
FRAMES_SPACE = [("frames", 2), ("space", 2)]
MESHES = {"frames2": FRAMES2, "space2": SPACE2, "frames2_space2": FRAMES_SPACE}


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


# -- the window's shares and its Gram ------------------------------------------------


def test_window_shares_even_in_window_order():
    def sizes(axes, t_w):
        return [(len(row), part.stop - part.start, part.start) for row, part in window_shares(sharding_for(_mesh(axes)), t_w)]

    assert sizes(FRAMES2, 9) == [(1, 5, 0), (1, 4, 5)]  # frame_shards would leave 9 frames unshared
    assert sizes(FRAMES2, 8) == [(1, 4, 0), (1, 4, 4)]
    assert sizes(FRAMES4, 7) == [(1, 2, 0), (1, 2, 2), (1, 2, 4), (1, 1, 6)]
    assert sizes(FRAMES2, 1) == [(1, 1, 0), (1, 0, 1)]  # a 1-frame window: the second row sits idle
    assert sizes(FRAMES_SPACE, 7) == [(2, 4, 0), (2, 3, 4)]
    assert sizes(SPACE2, 7) == [(2, 7, 0)]


def _layout(axes, frames, height, width, channels=3):
    shares = [(row, part) for row, part in window_shares(sharding_for(_mesh(axes)), frames) if part.stop > part.start]
    n = len(shares[0][0])
    return spatial.WindowLayout(shares, spatial.band_rows(height, n, 8) if n > 1 else [height], channels, width)


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("axes, frames", [(FRAMES2, 8), (FRAMES2, 9), (FRAMES2, 7), (FRAMES_SPACE, 9), (SPACE2, 7)],
                         ids=["4+4", "5+4", "4+3", "frames2_space2", "space2"])
def test_window_gram_of_shares_matches_video_gram(axes, frames, use_covariance):
    """``shared_video_gram`` of the window's shares (and bands) and, on one
    share, ``banded_video_gram`` of its bands, against ``video_gram`` of the
    whole window: the (T·C, T·C) Gram and its gradient (a random,
    asymmetric cotangent) within 1e-6 relative, in norm (f32: bands sum in
    another order, and a covariance Gram's largest entry lies up to ten
    spacings off)."""
    gen = torch.Generator().manual_seed(frames)
    x = torch.relu(torch.randn((frames, 6, 24, 10), generator=gen)).requires_grad_(True)
    w = torch.randn((frames * 6, frames * 6), generator=gen)
    want = video_gram(x, use_covariance)
    (gwant,) = torch.autograd.grad(torch.sum(want * w), x)
    want = want.detach()
    layout = _layout(axes, frames, 24, 10, 6)
    pieces = layout.split(x)
    shares = layout.by_share(pieces)
    got = shared_video_gram(shares, use_covariance) if len(shares) > 1 else banded_video_gram(shares[0], use_covariance)
    gpieces = torch.autograd.grad(torch.sum(got * w), pieces)
    ggot = layout.gather(gpieces, CPU)
    assert got.shape == want.shape
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-6
    assert float(torch.linalg.norm(ggot - gwant) / torch.linalg.norm(gwant)) <= 1e-6


def test_window_layout_round_trips_state():
    """A window-sized image and the flat L-BFGS rows of one, through the
    pieces of a frames:2,space:2 layout (5 + 4 frames, bands of 16 and 24
    rows) and back, bit for bit."""
    layout = _layout(FRAMES_SPACE, 9, 40, 7)
    x = torch.arange(9 * 3 * 40 * 7, dtype=torch.float32).reshape(9, 3, 40, 7)
    pieces = layout.split(x)
    assert [tuple(p.shape) for p in pieces] == [(5, 3, 16, 7), (5, 3, 24, 7), (4, 3, 16, 7), (4, 3, 24, 7)]
    assert torch.equal(layout.gather(pieces, CPU), x)
    hist = torch.stack([x.flatten(), -x.flatten()])
    rows = layout.split(hist)
    assert torch.equal(rows[3], torch.stack([pieces[3].flatten(), -pieces[3].flatten()]))
    assert torch.equal(layout.gather(rows, CPU), hist)
    assert layout.frozen_cut((6, 2)) == [(5, 0), (1, 2)]


# -- windowed runs against JAX's sharded engine ---------------------------------------------


def _jax_engine(sharding):
    """JAX tests/test_parallel.py:92-114's engine: VGG-16 (plain stem),
    content relu2_2, style relu1_1 and relu2_1, video_style_factor 100,
    Adam lr 0.1."""
    cfg = JaxLossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), tv_weight=1e-3,
                        temporal_weight=0.0, video_style_factor=100.0)
    spec = jax_select_model("vgg16", "max")
    return JaxEngine(spec, jax_init_params(spec, seed=0), cfg, optimizer="adam", learning_rate=0.1,
                     pastiche_sharding=sharding, pack_stem=False)


def _port_engine(mesh):
    cfg = LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), tv_weight=1e-3,
                     temporal_weight=0.0, video_style_factor=100.0)
    params = params_from_jax(jax_init_params(jax_select_model("vgg16", "max"), seed=0))
    return StyleEngine(select_model("vgg16", "max"), params, cfg, optimizer="adam", learning_rate=0.1, device="cpu",
                       mesh=mesh)


def _jax_sharding(axes):
    n = int(np.prod([s for _, s in axes]))
    spec = {"frames": P("frames", None, None, None), "space": P(None, "space", None, None)}
    names = [a for a, _ in axes]
    return NamedSharding(jax_build_mesh(jax.devices()[:n], axes),
                         P("frames", "space", None, None) if len(names) == 2 else spec[names[0]])


def _window_inputs(side, frames=8, seed=3):
    """JAX tests/test_parallel.py:92-114's inputs at ``side``² frames."""
    np.random.seed(seed)
    content = np.random.rand(1, side, side, 3).astype(np.float32) * 100
    style = np.random.rand(8, side, side, 3).astype(np.float32) * 100
    init = np.random.randn(frames, side, side, 3).astype(np.float32) * 0.001
    return content, style, init


def _windowed(engine, content, style, init, n_iters=3):
    return np.asarray(engine.optimize(content, [style], init.copy(), n_iters, transfer_type="img_vid",
                                      blend_weights=[1.0], gram_frame_window=4, avg_frame_window=-1))


@pytest.mark.parametrize("side, axes", [(16, FRAMES4), (32, SPACE2), (32, FRAMES_SPACE)],
                         ids=["16_frames4", "32_space2", "32_frames2_space2"])
def test_windows_on_a_mesh_match_jax_sharded(side, axes, monkeypatch):
    """JAX tests/test_parallel.py:92-114: 8 frames, gfw 4, Adam lr 0.1, 3
    iterations a window, the port on ``axes`` of CPU entries against JAX on
    the same axes of its virtual devices (P("frames"), P(None, "space"),
    P("frames", "space")) and against the port unsharded: atol 1e-4, rtol
    1e-4, and the loss logs within rtol 1e-4.  Every window's frames are
    shared out to the rows (frames:4: one frame a row)."""
    content, style, init = _window_inputs(side)
    want = _windowed(_jax_engine(_jax_sharding(axes)), content, style, init)
    single = _port_engine(None)
    ref = _windowed(single, content, style, init)
    seen = []
    orig = StyleEngine._window_pieces

    def recording(self, layout, pieces, *a, **k):
        seen.append([tuple(p.shape) for p in pieces])
        return orig(self, layout, pieces, *a, **k)

    monkeypatch.setattr(StyleEngine, "_window_pieces", recording)
    engine = _port_engine(_mesh(axes))
    got = _windowed(engine, content, style, init)
    bands, rows = dict(axes).get("space", 1), dict(axes).get("frames", 1)
    assert len(seen) == 3 and all(s == [(4 // rows, 3, side // bands, side)] * (rows * bands) for s in seen)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(engine.last_loss_log, single.last_loss_log, rtol=1e-4, atol=0)


def test_one_frame_pastiche_on_frames2():
    """A 1-frame pastiche (gfw 4) on frames:2: one share of one frame, the
    second row idle, no dynamic term; against JAX on its frames:2 sharding
    and against the port unsharded (atol 1e-4, rtol 1e-4)."""
    content, style, init = _window_inputs(16, frames=1)
    want = _windowed(_jax_engine(_jax_sharding(FRAMES2)), content, style, init)
    single = _port_engine(None)
    ref = _windowed(single, content, style, init)
    engine = _port_engine(_mesh(FRAMES2))
    assert [p.stop - p.start for _, p in window_shares(engine.sharding, 1)] == [1, 0]
    got = _windowed(engine, content, style, init)
    assert engine.last_loss_log.shape == (2 * 3, 4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(engine.last_loss_log, single.last_loss_log, rtol=1e-4, atol=0)


# -- L-BFGS, the frozen split and run-state checkpoints on a mesh ---------------------------------


def _narrow(mesh=None, optimizer="lbfgs"):
    """A narrow VGG-19 (tests/test_torch_img_vid.py's widths, VGG-19's
    layer names and pools: bands at multiples of 16 rows), the default
    layers, video_style_factor 100, lr 1, history 5."""
    spec = registry._vgg_spec("vgg19", NARROW, "max")
    return StyleEngine(spec, init_params(spec, seed=0), LossConfig(video_style_factor=100.0), optimizer=optimizer,
                       learning_rate=1.0, lbfgs_history=5, device="cpu", mesh=mesh)


def _small_window_inputs(seed, frames=8):
    """tests/test_torch_img_vid.py's small inputs (pixels in [0, 1), an init
    of 0.001·N(0, 1)) at 32 rows, two bands of 16."""
    rng = np.random.default_rng(seed)
    content = rng.random((1, 32, 24, 3)).astype(np.float32)
    styles = [rng.random((8, 32, 28, 3)).astype(np.float32)]
    return content, styles, rng.normal(0, 0.001, (frames, 32, 24, 3)).astype(np.float32)


def _totals_apart(log, ref):
    return np.abs(log.sum(axis=1) - ref.sum(axis=1)) / np.abs(ref.sum(axis=1))


@pytest.mark.parametrize("mesh", ["space2", "frames2", "frames2_space2"])
def test_lbfgs_windows_on_a_mesh_match_unsharded(mesh):
    """L-BFGS windows (8 frames, gfw 4, 3 iterations a window, the frozen
    split) on the mesh against unsharded: each window's first two totals
    within rtol 1e-5, every total within rtol 1e-4 (the random init's
    first step is not float noise), mean|Δ| within 1e-2 of mean|p|."""
    content, styles, init = _small_window_inputs(0)
    kw = dict(transfer_type="img_vid", gram_frame_window=4)
    single = _narrow()
    ref = single.optimize(content, styles, init, 3, **kw)
    engine = _narrow(_mesh(MESHES[mesh]))
    got = engine.optimize(content, styles, init, 3, **kw)
    rtol = _totals_apart(engine.last_loss_log, single.last_loss_log).reshape(3, 3)
    assert rtol[:, :2].max() <= 1e-5 and rtol.max() <= 1e-4, rtol
    assert np.abs(got - ref).mean() <= 1e-2 * np.abs(ref).mean()
    assert np.abs(got - init).max() > 1e-3


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
@pytest.mark.parametrize("mesh", ["frames2", "frames2_space2"])
def test_frozen_split_matches_masked_on_a_mesh(monkeypatch, optimizer, mesh):
    """The frozen-split runner (each share's frozen frames extracted once,
    on its row) against the masked runner (the mask cut by share), both on
    the mesh, within tests/test_torch_img_vid.py's 2e-4.  Window 1
    freezes the first share's first frame, window 2 that frame and the
    whole second share (its last two frames)."""
    content, styles, init = _small_window_inputs(1)
    outs = []
    for split in (False, True):
        monkeypatch.setattr(optimize_module, "_WINDOW_SPLIT", split)
        engine = _narrow(_mesh(MESHES[mesh]), optimizer)
        calls = []
        real = engine._run
        monkeypatch.setattr(engine, "_run", lambda *a, **kw: calls.append((kw.get("frozen"), kw.get("mask"))) or real(*a, **kw))
        outs.append(engine.optimize(content, styles, init, 3, transfer_type="img_vid", gram_frame_window=4))
        assert [f for f, _ in calls] == ([None, (1, 0), (1, 2)] if split else [None] * 3)
        assert all((m is not None) == (not split and i > 0) for i, (_, m) in enumerate(calls))
    assert np.abs(outs[0] - init).max() > 1e-3
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)


def _crashing(engine, crash_at, monkeypatch):
    real, calls = engine._run, []

    def crash(*a, **k):
        calls.append(k)
        if len(calls) == crash_at:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(engine, "_run", crash)
    return engine


def test_checkpointed_mesh_run_resumes(tmp_path, monkeypatch):
    """On frames:2,space:2, chunks of 2 of 4 iterations: a crash in the
    middle of window 1 saves the single-device layout (the window's whole
    pastiche and L-BFGS rows), and the resumed mesh run equals an
    uninterrupted checkpointed one exactly."""
    content, styles, init = _small_window_inputs(2)
    kw = dict(transfer_type="img_vid", gram_frame_window=4, checkpoint_every=2)
    engine = _narrow(_mesh(FRAMES_SPACE))
    want = engine.optimize(content, styles, init, 4, run_checkpoint=str(tmp_path / "whole"), **kw)
    want_log = engine.last_loss_log

    run_dir = str(tmp_path / "rs")
    with pytest.raises(KeyboardInterrupt):
        _crashing(_narrow(_mesh(FRAMES_SPACE)), 4, monkeypatch).optimize(content, styles, init, 4,
                                                                         run_checkpoint=run_dir, **kw)
    saved = torch.load(os.path.join(run_dir, "state.pt"), weights_only=True)
    assert (saved["window"], saved["done_iters"]) == (1, 2)
    assert saved["pastiche"]["pastiche"].shape == (4, 3, 32, 24)
    assert saved["opt_state"]["s_hist"].shape == (5, 4 * 3 * 32 * 24)

    engine = _narrow(_mesh(FRAMES_SPACE))
    got = engine.optimize(content, styles, init, 4, run_checkpoint=run_dir, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(engine.last_loss_log, want_log[-engine.last_loss_log.shape[0]:])
    assert not os.path.exists(run_dir)


def test_mesh_and_single_device_runs_resume_each_other(tmp_path, monkeypatch):
    """A one-device run's checkpoint resumes on frames:2,space:2 and the
    other way round; either ends within 1e-4 of the uninterrupted
    one-device run."""
    content, styles, init = _small_window_inputs(3)
    kw = dict(transfer_type="img_vid", gram_frame_window=4, checkpoint_every=2)
    want = _narrow().optimize(content, styles, init, 4, run_checkpoint=str(tmp_path / "whole"), **kw)
    for first, second in ((None, FRAMES_SPACE), (FRAMES_SPACE, None)):
        run_dir = str(tmp_path / "rs")
        with pytest.raises(KeyboardInterrupt):
            _crashing(_narrow(first and _mesh(first)), 4, monkeypatch).optimize(content, styles, init, 4,
                                                                                run_checkpoint=run_dir, **kw)
        assert os.path.isdir(run_dir)
        got = _narrow(second and _mesh(second)).optimize(content, styles, init, 4, run_checkpoint=run_dir, **kw)
        assert not os.path.exists(run_dir)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- the style CLI against JAX's, and similarity's jobs ---------------------------------------------


def _write_cli_inputs(d):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    content = np.stack([xx * 4 % 256, yy * 5 % 256, ((xx - 30) ** 2 + (yy - 20) ** 2 < 200) * 255], -1)
    Image.fromarray(content.astype(np.uint8)).save(d / "content.png")
    sy, sx = np.mgrid[0:40, 0:40]
    frames = [np.stack([np.sin((sx + 3 * t) / 3), np.cos((sy - 2 * t) / 4), np.sin((sx + sy) / 5)], -1)
              for t in range(5)]
    np.save(d / "sv.npy", ((np.stack(frames) * 0.5 + 0.5) * 255 + rng.integers(0, 8, (5, 40, 40, 3))).astype(np.uint8))


@pytest.mark.parametrize("mesh", ["frames:2", "space:2"])
def test_img_vid_cli_on_a_mesh_matches_jax(tmp_path, monkeypatch, mesh):
    """The img_vid CLI (tests/test_torch_img_vid.py's run: 4 frames, gfw
    3,2, Adam, VGG-19 to relu3_1) with ``--gpu c --mesh`` ``mesh`` on both
    CLIs: every engine on the mesh, the stacks within the u8 drift bounds
    of JAX's (max ≤ 6, mean ≤ 0.5, ≤ 2% of pixels past 2), and the loss
    logs within rtol 1e-3 of JAX's, as unsharded."""
    _write_cli_inputs(tmp_path)
    npz = tmp_path / "vgg19.npz"
    save_npz_params(jax_init_params(jax_select_model("vgg19")), str(npz))

    def argv(out):
        return ["--transfer_type", "img_vid", "--content", str(tmp_path / "content.png"), "--style",
                str(tmp_path / "sv.npy"), "--output_dir", str(tmp_path / out), "--gpu", "c", "--model_file", str(npz),
                "--image_sizes", "32,48", "--num_iters", "3,2", "--num_frames", "4", "--gram_frame_window", "3,2",
                "--avg_frame_window", "4", "--optimizer", "adam", "--seed", "0", "--mesh", mesh,
                "--style_layers", "relu1_1,relu2_1,relu3_1", "--content_layers", "relu3_1"]

    engines = {"jax": [], "torch": []}
    for key, module in (("jax", jax_img_vid), ("torch", torch_img_vid)):
        orig = module.build_engine
        monkeypatch.setattr(module, "build_engine", lambda args, size=None, orig=orig, key=key:
                            engines[key].append(orig(args, size)) or engines[key][-1])
    jax_style.main(argv("jax"))
    torch_style.main(argv("torch"))
    assert [e.mesh.axes for e in engines["torch"]] == [tuple(config.parse_mesh(mesh))] * 2
    for stem in ("content_sv_32", "content_sv_48", "content_sv"):
        want = np.load(tmp_path / "jax" / f"{stem}.npy")
        got = np.load(tmp_path / "torch" / f"{stem}.npy")
        assert got.shape == ((4, 24, 32, 3) if stem.endswith("32") else (4, 36, 48, 3))
        _u8_drift(got, want)
    for je, te in zip(engines["jax"], engines["torch"]):
        np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)


def test_similarity_jobs_on_space2_match_one_device(tmp_path, monkeypatch):
    """similarity on ``--gpu c --mesh space:2`` over 3 images of 32² (two
    bands of 16 rows at VGG-19's relu5_1): its 9 img_img jobs run on the
    mesh, and each job's artifact lies within the u8 drift bounds of
    tests/test_torch_img_img.py of the same job run alone through the
    port's img_img on one device (``--gpu c``), with the loss logs within
    rtol 1e-4: L-BFGS without histogram matching, as the banded img_img
    CLI test runs it.  A term may instead lie within 1e-6 of its
    iteration's total: from the 0.001·N(0, 1) init TV is ≈ 1e-7 of the
    total, and where rounding flips a ReLU gate on a near-zero
    pre-activation the gradient moves (one job's relu5_1 term 1.9% banded
    at one torch thread, 6e-7 at two), which L-BFGS carries into TV's
    value (3.2e-3 of it, 3e-10 of the total)."""
    from maua_style_tpu_torch.pipelines import img_img, similarity

    data = tmp_path / "data"
    data.mkdir()
    _dataset(data, n=3, side=32)
    engines = []
    orig = img_img.build_engine

    def build_engine(args, current_size=None):
        engines.append(orig(args, current_size))
        return engines[-1]

    monkeypatch.setattr(img_img, "build_engine", build_engine)

    def args(out, mesh):
        return config.get_args(["--gpu", "c", "--mesh", mesh, "--content", "c.png", "--style", "s.png",
                                "--output_dir", str(tmp_path / out), "--image_sizes", "32", "--num_iters", "4",
                                "--no_hist_match", "--scaling_args", str(tmp_path / "none.json"), "--seed", "0"])

    np.random.seed(0)  # img_img draws its random init from numpy's global stream
    jobs = similarity.run(str(data), args("mesh", "space:2"))
    banded = list(engines)
    engines.clear()
    # the jobs again on one device, each its own img_img run, from the same
    # random inits
    np.random.seed(0)
    assert similarity.run(str(data), args("single", "space:1")) == jobs
    assert len(jobs) == len(banded) == len(engines) == 9
    assert all(e.band_devices == [CPU, CPU] for e in banded) and all(e.band_devices is None for e in engines)
    for b, s in zip(banded, engines):
        total = np.abs(s.last_loss_log.sum(axis=1, keepdims=True))
        assert (np.abs(b.last_loss_log - s.last_loss_log) <= 1e-4 * np.abs(s.last_loss_log) + 1e-6 * total).all()
    outs = sorted(os.listdir(tmp_path / "mesh"))
    assert len(outs) == 9 and outs == sorted(os.listdir(tmp_path / "single"))
    for f in outs:
        _assert_u8_drift(str(tmp_path / "mesh" / f), str(tmp_path / "single" / f))


def test_img_vid_scaling_table_keeps_the_mesh(tmp_path, monkeypatch):
    """A scaling table's per-scale swap (``set_model_args``: here Adam at
    32 px, L-BFGS at 48 with the table's own ``mesh`` entry) changes each
    scale's engine settings but not its mesh: both engines run on
    ``--mesh frames:2``'s shares."""
    _write_cli_inputs(tmp_path)
    table = tmp_path / "scaling.json"
    table.write_text('{"32": {"optimizer": "adam", "devices": 1}, '
                     '"48": {"optimizer": "lbfgs", "devices": 2, "mesh": "space:2"}}')
    engines, shares = [], []
    orig = torch_img_vid.build_engine
    monkeypatch.setattr(torch_img_vid, "build_engine", lambda args, size=None: engines.append(orig(args, size))
                        or engines[-1])
    real = StyleEngine._window_layout
    monkeypatch.setattr(StyleEngine, "_window_layout", lambda self, t_w, hw: shares.append(
        [p.stop - p.start for _, p in real(self, t_w, hw).shares]) or real(self, t_w, hw))
    torch_style.main(["--transfer_type", "img_vid", "--content", str(tmp_path / "content.png"), "--style",
                      str(tmp_path / "sv.npy"), "--output_dir", str(tmp_path / "out"), "--gpu", "c", "--mesh", "frames:2",
                      "--image_sizes", "32,48", "--num_iters", "1,1", "--num_frames", "4", "--gram_frame_window", "3,2",
                      "--allow_random_weights", "--seed", "0", "--scaling_args", str(table),
                      "--style_layers", "relu1_1,relu2_1", "--content_layers", "relu2_1"])
    assert [e.optimizer_name for e in engines] == ["adam", "lbfgs"]
    assert [e.mesh.axes for e in engines] == [(("frames", 2),)] * 2
    assert shares == [[2, 1]] * 3 + [[1, 1]] * 3  # ceil(4 / gfw) + 1 windows of gfw frames at each scale
