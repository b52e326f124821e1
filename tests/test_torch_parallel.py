"""The port's multi-device runs (``parallel/``) against the JAX package's
``parallel/mesh.py`` policy and against the port's own unsharded runs, on
meshes of repeated CPU entries (JAX's suite uses 8 virtual CPU devices):
the mesh and its policy, the halo exchange's gradient, one banded step
against the unbanded one, ``StyleEngine.optimize`` on "space" and
``optimize_frames`` on "frames" against unsharded (JAX
tests/test_parallel.py's cases and bars), the style CLI with ``--gpu c
--mesh space:2`` against JAX's, the frame loop's auto batch, and the raise
of every path left on one device (vid_img's paths on "space" and on
combined meshes: ``tests/test_torch_parallel_video.py``; img_vid's windows
and similarity's jobs: ``tests/test_torch_parallel_windows.py``)."""

import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from jax.sharding import PartitionSpec as P

from maua_style_tpu import config as jax_config
from maua_style_tpu import style as jax_style
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu.parallel import build_mesh as jax_build_mesh
from maua_style_tpu.parallel import pastiche_sharding_for as jax_sharding_for
from maua_style_tpu_torch import config
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine import optimize as optimize_module
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.parallel import build_mesh, frame_shards, pastiche_sharding_for, sharding_for, spatial
from maua_style_tpu_torch.pipelines import frame_loop
from test_torch_img_img import _assert_u8_drift, torch_img_img
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CPU = torch.device("cpu")


def _mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return build_mesh([CPU] * n, axes)


def _small_engine(mesh=None, optimizer="adam"):
    """JAX tests/test_parallel.py's ``_engine``: VGG-16, content relu2_2,
    style relu1_1 and relu2_1, lr 0.1."""
    cfg = LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), tv_weight=1e-3,
                     temporal_weight=0.0, normalize_gradients=True)
    spec = select_model("vgg16", "max")
    return StyleEngine(spec, init_params(spec, seed=0), cfg, optimizer=optimizer, learning_rate=0.1, device="cpu",
                       mesh=mesh)


# -- the mesh and its policy (JAX tests/test_parallel.py:38-41, 74-90) --------


def test_mesh_build():
    mesh = build_mesh([CPU] * 8, [("frames", 2), ("space", 4)])
    assert mesh.shape == dict(jax_build_mesh(jax.devices(), [("frames", 2), ("space", 4)]).shape)
    assert build_mesh([CPU] * 3).axes == (("space", 3),)  # every device on "space", as JAX's default
    assert len(build_mesh([CPU] * 8, [("space", 2)]).devices) == 2  # the first devices the axes span
    with pytest.raises(ValueError):
        build_mesh([CPU] * 2, [("space", 4)])


@pytest.mark.parametrize("n, axes", [(8, [("frames", 2), ("space", 4)]), (1, [("space", 1)]),
                                     (6, [("space", 2), ("tensor", 3)]), (4, [("frames", 4)]),
                                     (8, [("space", 2)])])
def test_pastiche_sharding_for_policy(n, axes):
    """The same axis on the same dim as JAX's NHWC spec (the port's is NCHW)."""
    jax_args = argparse.Namespace(devices=jax.devices()[:n], mesh_shape=axes)
    port_args = argparse.Namespace(devices=[CPU] * n, mesh_shape=axes)
    want, got = jax_sharding_for(jax_args), pastiche_sharding_for(port_args)
    if want is None:
        assert got is None
        return
    spec = tuple(want.spec) + (None,) * (4 - len(want.spec))
    assert got.spec == (spec[0], spec[3], spec[1], spec[2])
    assert got.mesh.shape == dict(want.mesh.shape)
    if n == 8 and len(axes) == 2:
        assert want.spec == P("frames", "space", None, None)


def test_frame_shards():
    plan = sharding_for(_mesh([("frames", 2)]))
    assert frame_shards(plan, 4) == [((CPU,), slice(0, 2)), ((CPU,), slice(2, 4))]  # one row of one device each
    assert frame_shards(plan, 3) is None  # JAX's rule: the chunk runs unsharded
    assert frame_shards(sharding_for(_mesh([("space", 2)])), 4) is None and frame_shards(None, 4) is None
    assert sharding_for(None) is None and sharding_for(_mesh([("space", 1)])) is None


# -- bands and the halo exchange ------------------------------------------------


def test_band_rows_and_alignment():
    vgg19 = select_model("vgg19")
    assert spatial.band_alignment(StyleEngine(vgg19, init_params(vgg19), LossConfig(), device="cpu").spec) == 16
    assert spatial.band_rows(72, 4, 16) == [16, 16, 16, 24]  # the ragged remainder in the last band
    assert spatial.band_rows(56, 2, 16) == [32, 24]
    assert spatial.band_rows(1024, 2, 16) == [512, 512]
    with pytest.raises(ValueError):
        spatial.band_rows(40, 4, 16)
    for model in ("vgg16", "prune", "sod", "nyud", "fcn32s"):
        assert spatial.band_alignment(select_model(model)) == 32
    # NIN up to relu11 and whole: conv1's stride 4 and three 3x3/2 pools (pool4 is 6x6/1)
    nin = StyleEngine(select_model("nin"), init_params(select_model("nin")),
                      LossConfig(content_layers=("relu8",), style_layers=("relu1", "relu11")), device="cpu").spec
    assert spatial.band_alignment(nin) == 32 and spatial.band_alignment(select_model("nin")) == 32


@pytest.mark.parametrize("neighbours", ["both", "above", "below"])
def test_halo_pad_gradcheck(neighbours):
    gen = torch.Generator().manual_seed(0)

    def rnd(h):
        return torch.randn((1, 2, h, 5), generator=gen, dtype=torch.float64, requires_grad=True)

    x, above, below = rnd(3), rnd(4), rnd(2)
    above = above if neighbours in ("both", "above") else None
    below = below if neighbours in ("both", "below") else None
    out = spatial.halo_pad(x, above, below, 1, 1)
    assert out.shape == (1, 2, 5, 5)
    if above is None:
        assert torch.all(out[:, :, 0] == 0)
    else:
        assert torch.equal(out[:, :, 0], above[:, :, -1])
    inputs = tuple(t for t in (x, above, below) if t is not None)

    def fn(*ts):
        it = iter(ts)
        return spatial.halo_pad(next(it), next(it) if above is not None else None,
                                next(it) if below is not None else None, 1, 1)

    assert torch.autograd.gradcheck(fn, inputs)


@pytest.fixture(scope="module")
def vgg19_engine():
    spec = select_model("vgg19")
    return spec, init_params(spec, seed=0)


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("n, height", [(2, 64), (2, 56), (4, 72)])
def test_banded_step_matches_unbanded(vgg19_engine, use_covariance, n, height):
    """One step's loss terms and gradient, VGG-19 with the default layers,
    on ``n`` CPU entries (heights 56 and 72: a ragged last band) against
    the unbanded step: within 1e-5 relative."""
    spec, params = vgg19_engine
    cfg = LossConfig(use_covariance=use_covariance)
    engine = StyleEngine(spec, params, cfg, device="cpu")
    rng = np.random.default_rng(n + height)
    width = 40
    content = rng.random((1, height, width, 3), np.float32) * 100
    style = rng.random((1, 48, 48, 3), np.float32) * 100
    p = torch.from_numpy(rng.standard_normal((1, 3, height, width)).astype(np.float32) * 50)
    targets = {"content": engine.content_targets(content), "style": engine.style_targets([style], [1.0])}
    x = p.clone().requires_grad_(True)
    total, per = evaluate_losses(x, engine._extract(x, cfg.all_layers), targets, cfg)
    (grad,) = torch.autograd.grad(total, x)

    heights = spatial.band_rows(height, n, 16)
    devices = [CPU] * n
    bands = [b.requires_grad_(True) for b in spatial.split_rows(p, heights, devices, 3, width)]
    level = spatial.level_heights(heights, engine.spec, "relu4_2")  # after three pools
    banded_targets = {"style": targets["style"], "content": {
        l: spatial.split_rows(t, level, devices, t.shape[1], t.shape[3]) for l, t in targets["content"].items()}}
    btotal, bper = evaluate_banded_losses(bands, engine._extract_bands(bands, cfg.all_layers), banded_targets, cfg)
    bgrad = spatial.gather_rows(torch.autograd.grad(btotal, bands), heights, CPU, 3, width)
    np.testing.assert_allclose(bper.detach().numpy(), per.detach().numpy(), rtol=1e-5, atol=0)
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-5


def test_split_and_gather_rows_round_trip():
    heights, w = [16, 24], 5
    img = torch.arange(3 * 40 * w, dtype=torch.float32).reshape(1, 3, 40, w)
    bands = spatial.split_rows(img, heights, [CPU, CPU], 3, w)
    assert [tuple(b.shape) for b in bands] == [(1, 3, 16, w), (1, 3, 24, w)]
    assert torch.equal(spatial.gather_rows(bands, heights, CPU, 3, w), img)
    hist = torch.stack([img.flatten(), -img.flatten()])  # (m, N), the L-BFGS layout
    pieces = spatial.split_rows(hist, heights, [CPU, CPU], 3, w)
    assert torch.equal(pieces[0], torch.stack([bands[0].flatten(), -bands[0].flatten()]))
    assert torch.equal(spatial.gather_rows(pieces, heights, CPU, 3, w), hist)


# -- the engine on a mesh against unsharded --------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_spatial_sharding_matches_single_device(optimizer):
    """JAX tests/test_parallel.py:43-56: 5 iterations on space:4 against
    one device, atol = rtol = 1e-4 (and the loss logs)."""
    np.random.seed(0)
    content = np.random.rand(1, 32, 32, 3).astype(np.float32) * 100
    style = np.random.rand(1, 32, 32, 3).astype(np.float32) * 100
    init = np.random.randn(1, 32, 32, 3).astype(np.float32) * 0.001
    e0 = _small_engine(None, optimizer)
    single = e0.optimize(content, [style], init.copy(), 5, blend_weights=[1.0])
    e4 = _small_engine(_mesh([("space", 4)]), optimizer)
    assert e4.band_devices == [CPU] * 4 and e4.band_align == 2
    sharded = e4.optimize(content, [style], init.copy(), 5, blend_weights=[1.0])
    np.testing.assert_allclose(sharded, single, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(e4.last_loss_log, e0.last_loss_log, rtol=1e-4, atol=1e-6)


def test_banded_checkpoints_are_single_device_layout(tmp_path, monkeypatch):
    """A banded run's run-state resumes an unbanded run and the other way
    round: both layouts are the single-device one, and an interrupted run
    either way ends where an uninterrupted one does."""
    rng = np.random.default_rng(1)
    content = rng.random((1, 32, 32, 3), np.float32) * 100
    style = rng.random((1, 32, 32, 3), np.float32) * 100
    init = rng.standard_normal((1, 32, 32, 3)).astype(np.float32) * 0.001
    want = _small_engine(None, "lbfgs").optimize(content, [style], init.copy(), 6, blend_weights=[1.0])
    save_state = optimize_module.save_state

    def save_and_stop(*a):
        save_state(*a)
        raise KeyboardInterrupt

    for first, second in ((_mesh([("space", 2)]), None), (None, _mesh([("space", 2)]))):
        ckpt = str(tmp_path / "runstate")
        with monkeypatch.context() as m, pytest.raises(KeyboardInterrupt):
            m.setattr(optimize_module, "save_state", save_and_stop)
            _small_engine(first, "lbfgs").optimize(content, [style], init.copy(), 6, blend_weights=[1.0],
                                                   run_checkpoint=ckpt, checkpoint_every=3)
        assert os.path.isdir(ckpt)
        got = _small_engine(second, "lbfgs").optimize(content, [style], init.copy(), 6, blend_weights=[1.0],
                                                      run_checkpoint=ckpt, checkpoint_every=3)
        assert not os.path.exists(ckpt)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_batched_frames_split_matches_single_device(monkeypatch):
    """JAX tests/test_parallel.py:185-213: optimize_frames on frames:2
    against the unsharded batch (atol 1e-3, rtol 1e-4; displays within one
    level), each device running its own half; a batch of 3 falls back to
    unsharded."""
    rng = np.random.default_rng(4)
    contents = rng.integers(0, 255, (4, 24, 24, 3)).astype(np.uint8)
    style = rng.random((1, 20, 20, 3), np.float32) * 255 - 128
    kw = dict(out_hw=(20, 20), init_mode="content", blend_weights=[1.0])
    pb0, db0 = _small_engine(None).optimize_frames(contents, [style], 5, **kw)

    jobs = []
    orig = StyleEngine._frames_job

    def recording(self, contents_u8, *a, **k):
        jobs.append(len(contents_u8))
        return orig(self, contents_u8, *a, **k)

    monkeypatch.setattr(StyleEngine, "_frames_job", recording)
    engine = _small_engine(_mesh([("frames", 2)]))
    pb, db = engine.optimize_frames(contents, [style], 5, **kw)
    assert jobs == [2, 2]
    assert engine.last_loss_log.shape == (4, 5, 4)
    np.testing.assert_allclose(pb.numpy(), pb0.numpy(), atol=1e-3, rtol=1e-4)
    assert np.abs(db.numpy().astype(int) - db0.numpy().astype(int)).max() <= 1

    jobs.clear()
    pb3, _ = engine.optimize_frames(contents[:3], [style], 5, **kw)
    assert jobs == [3]
    np.testing.assert_allclose(pb3.numpy(), pb0.numpy()[:3], atol=1e-3, rtol=1e-4)


def test_frames_mesh_per_frame_pass_runs_on_the_first_device():
    """JAX tests/test_parallel.py:216-232: a per-frame pass on a frames
    mesh runs frames-stripped, on the first device."""
    rng = np.random.default_rng(5)
    content = rng.integers(0, 255, (24, 24, 3)).astype(np.uint8)
    style = rng.random((1, 20, 20, 3), np.float32) * 255 - 128
    kw = dict(out_hw=(20, 20), init_mode="content", blend_weights=[1.0])
    p1, _ = _small_engine(_mesh([("frames", 2)])).optimize_frame(content, [style], 5, **kw)
    p0, _ = _small_engine(None).optimize_frame(content, [style], 5, **kw)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), atol=1e-3, rtol=1e-4)


# -- the CLI ------------------------------------------------------------------------


def _write_inputs(d):
    yy, xx = np.mgrid[0:60, 0:40]
    content = np.stack([xx * 4 % 256, yy * 6 % 256, ((xx - 20) ** 2 + (yy - 30) ** 2 < 200) * 255], -1)
    Image.fromarray(content.astype(np.uint8)).save(d / "content.png")
    s = (np.sin(yy / 3) * 127 + 128).astype(np.uint8)
    Image.fromarray(np.stack([s, 255 - s, np.roll(s, 8, 0)], -1)).save(d / "style.png")


# per model: --image_sizes, --num_iters and the layer flags.  VGG-19: a
# 40x60 content at 48 and 64 px, two bands of its 16-row multiples.  NIN:
# the scaling table's layers (configs/scaling-img.json from 6496 px) at 96
# and 128 px, two bands of its 32-row multiples (96 rows cut 32 + 64: an
# even cut leaves the last band no row after pool3)
CLI_MODELS = {
    "vgg19": ("48,64", "4,3", []),
    "nin": ("96,128", "4,3", ["--style_layers", "relu1,relu3,relu5,relu7,relu9,relu11", "--content_layers", "relu8"]),
}


@pytest.mark.parametrize("model", sorted(CLI_MODELS))
def test_img_img_cli_space2_matches_jax(tmp_path, monkeypatch, model):
    """``--gpu c --mesh space:2`` on both CLIs (``CLI_MODELS``' sizes),
    weights carried across in ``{model}.npz``: the port's two bands and
    JAX's two virtual devices within the u8 drift bounds of
    tests/test_torch_img_img.py, and the port's banded run against its
    unbanded one: the same artifacts within those bounds and the loss logs
    within rtol 1e-4.  L-BFGS without histogram matching, as there:
    matching between scales, and Adam's sign(g) steps from the 0.001·N(0,
    1) init, turn the 1e-7 by which a banded Gram sum differs into whole u8
    levels (73 at 48 px with both on; 0 without matching).  The port's
    loss logs against JAX's are not held here: at VGG-19's input the TV
    term (≈ 0.3 of ≈ 1e6) follows float noise by 2% at two torch threads,
    banded or not (tests/test_torch_img_img.py holds them at its input)."""
    _write_inputs(tmp_path)
    npz = tmp_path / f"{model}.npz"
    save_npz_params(jax_init_params(jax_select_model(model)), str(npz))
    sizes, iters, layers = CLI_MODELS[model]
    engines = []
    orig = torch_img_img.build_engine

    def build_engine(args, current_size=None):
        engines.append(orig(args, current_size))
        return engines[-1]

    monkeypatch.setattr(torch_img_img, "build_engine", build_engine)

    def argv(out, mesh):
        return ["--content", str(tmp_path / "content.png"), "--style", str(tmp_path / "style.png"),
                "--output_dir", str(tmp_path / out), "--gpu", "c", "--model_file", str(npz),
                "--image_sizes", sizes, "--num_iters", iters, "--seed", "0", "--optimizer", "lbfgs",
                "--no_hist_match", "--scaling_args", str(tmp_path / "none.json"), "--mesh", mesh, *layers]

    jax_style.main(argv("jax", "space:2"))
    torch_style.main(argv("torch", "space:2"))
    torch_style.main(argv("single", "space:1"))
    assert [e.band_devices for e in engines] == [[CPU, CPU]] * 2 + [None] * 2
    for banded, single in zip(engines[:2], engines[2:]):
        np.testing.assert_allclose(banded.last_loss_log, single.last_loss_log, rtol=1e-4, atol=1e-6)
    for size in sizes.split(","):
        name = f"content_style_{size}.png"
        _assert_u8_drift(str(tmp_path / "jax" / name), str(tmp_path / "torch" / name))
        _assert_u8_drift(str(tmp_path / "single" / name), str(tmp_path / "torch" / name))


# -- config and the frame loop -------------------------------------------------------


def test_frame_loop_auto_batch_times_the_frames_axis(tmp_path, monkeypatch):
    """JAX frame_loop.py:382-386: without --frame_batch the capacity
    model's batch is multiplied by the "frames" axis."""
    frames = []
    for i in range(8):
        frames.append(str(tmp_path / f"frame_{i:04d}.png"))
        Image.fromarray(np.full((8, 8, 3), i * 20, np.uint8)).save(frames[-1])
    monkeypatch.setattr(frame_loop, "_auto_frame_batch", lambda out_hw, requested, args=None: requested or 2)

    class Engine:
        def __init__(self, mesh):
            self.mesh, self.chunks = mesh, []

        def optimize_frames(self, stack, *a, **k):
            self.chunks.append(len(stack))
            return None, torch.zeros((len(stack), 8, 8, 3), dtype=torch.uint8)

    class Saver:
        def submit(self, *a):
            pass

    args = argparse.Namespace(loop=False, frame_batch=0, passes_per_scale=1, seed=0, init="content",
                              style_blend_weights=[1.0])
    got = {}
    for key, mesh, batch in (("none", None, 0), ("frames", _mesh([("frames", 2)]), 0),
                             ("space", _mesh([("space", 2)]), 0), ("requested", _mesh([("frames", 2)]), 2)):
        engine = Engine(mesh)
        args.frame_batch = batch
        frame_loop._device_first_pass_batched(args, engine, [], None, (8, 8), None, str(tmp_path / key), 8, 0,
                                              frames, 4, Saver())
        got[key] = engine.chunks
    assert got == {"none": [2, 2, 2, 2], "frames": [4, 4], "space": [2, 2, 2, 2], "requested": [2, 2, 2, 2]}


# -- every path this slice leaves on one device raises ------------------------------------


def _two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_engine_paths_run_on_tensor_and_nin_meshes():
    """img_vid's windows on "space × tensor" and "frames × tensor" meshes
    (items 18c and 18e3; they raised before 18e3) now run, finite and of
    the asked shape (their results against JAX's and unsharded runs:
    tests/test_torch_parallel_tensor_windows.py).  NIN on "space:2" and on
    "frames:2,space:2" (item 18k) now runs: an engine on two bands of 16-row
    multiples (NIN up to relu8), and vid_img's stacked first pass on the combined mesh giving
    finite frames of the asked shape (its results against unbanded runs:
    tests/test_torch_parallel_nin.py)."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    style = rng.random((1, 32, 32, 3), np.float32)
    for axes in ([("space", 2), ("tensor", 2)], [("frames", 2), ("tensor", 2)]):
        out = _small_engine(_mesh(axes)).optimize(style, [u8.astype(np.float32)], np.zeros((4, 32, 32, 3), np.float32),
                                                  1, transfer_type="img_vid", gram_frame_window=2)
        assert out.shape == (4, 32, 32, 3) and np.isfinite(out).all()
    spec = select_model("nin")
    nin_cfg = LossConfig(content_layers=("relu8",), style_layers=("relu1",))
    engine = StyleEngine(spec, init_params(spec), nin_cfg, device="cpu", mesh=_mesh([("space", 2)]))
    assert engine.band_devices == [CPU, CPU] and engine.band_align == 16  # up to relu8: conv1 and two pools
    combined = _mesh([("frames", 2), ("space", 2)])
    frames = rng.integers(0, 255, (4, 96, 40, 3)).astype(np.uint8)
    pastiches, displays = StyleEngine(spec, init_params(spec), nin_cfg, device="cpu", mesh=combined).optimize_frames(
        frames, [style], 1, out_hw=(96, 40), blend_weights=[1.0], init_mode="content")
    assert pastiches.shape == (4, 1, 3, 96, 40) and displays.shape == (4, 96, 40, 3)
    assert torch.isfinite(pastiches).all()


def test_single_device_clis_raise_on_a_mesh(tmp_path, monkeypatch):
    """clip_vqgan, the NCA trainer and generator on ``--gpu 0,1`` (two
    cards faked: nothing reaches CUDA before the raise) and clip_video_style
    on ``--gpu c --mesh space:2`` raise; similarity's jobs run on that mesh,
    as JAX runs them with the preset's devices (pipelines/similarity.py:
    123-130; their results: tests/test_torch_parallel_windows.py)."""
    from maua_style_tpu_torch.pipelines import clip_video_style, clip_vqgan, img_img, nca_gen, nca_train, similarity

    _two_cards(monkeypatch)
    with pytest.raises(NotImplementedError, match="JAX's CLI runs on one device"):
        clip_vqgan.main(["--content", "random", "--style_text", "x", "--gpu", "0,1", "--allow_random_weights"])
    with pytest.raises(NotImplementedError, match="JAX's CLI takes no device"):
        nca_train.main(["s.png", str(tmp_path / "nca"), "--gpu", "0,1"])
    with pytest.raises(NotImplementedError, match="JAX's CLI takes no device"):
        nca_gen.main(["s.png", str(tmp_path / "nca"), "--gpu", "0,1"])
    args = config.get_args(["--gpu", "c", "--mesh", "space:2", "--content", "c.png", "--style", "s.png"])
    with pytest.raises(NotImplementedError, match="JAX's CLI runs on one device"):
        clip_video_style.clip_video_style(args)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        Image.fromarray(np.full((8, 8, 3), 60 * i, np.uint8)).save(data / f"im{i}.png")
    jobs = []
    monkeypatch.setattr(img_img, "img_img", lambda a: jobs.append((a.content, a.devices, a.mesh_shape)))
    assert len(similarity.run(str(data), args)) == len(jobs) == 9
    assert all(devices == [CPU, CPU] and mesh == [("space", 2)] for _, devices, mesh in jobs)
