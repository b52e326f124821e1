"""The port's img_vid path (dynamic textures) against the JAX package's on
the CPU: the engine's window loop with a mixed image-and-video style, a
1-frame pastiche, per-window (--avg_frame_window) style targets, the
frozen-split runner against the masked one, a checkpointed window run
resumed mid-window, the engine's temporal_target argument, and the whole
CLI on a short .npy style stack.  A
narrow VGG-shaped net with the VGG-19 layer names keeps the engine tests
fast; the CLI runs VGG-19 (the JAX init saved as vgg19.npz)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import maua_style_tpu_torch.engine.optimize as teo
from maua_style_tpu import style as jax_style
from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.losses import LossConfig as JaxLossConfig
from maua_style_tpu.models import extractor as jax_ext
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import registry as jax_registry
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import registry
from maua_style_tpu_torch.models.convert import params_from_jax
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

jax_img_vid = importlib.import_module("maua_style_tpu.pipelines.img_vid")
torch_img_vid = importlib.import_module("maua_style_tpu_torch.pipelines.img_vid")

NARROW = [8, 8, "P", 16, 16, "P", 24, 24, "P", 32, 32, "P", 32, "P"]


def _engines(optimizer="adam", history=5, jax_too=True):
    jspec = jax_registry._vgg_spec("vgg19", NARROW, "max")
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jax_ext.init_params(jspec, 0).items()}
    cfg = dict(video_style_factor=100.0)
    lr = 1.0
    te = StyleEngine(registry._vgg_spec("vgg19", NARROW, "max"), params_from_jax(params), LossConfig(**cfg),
                     optimizer=optimizer, learning_rate=lr, lbfgs_history=history, device="cpu")
    if not jax_too:
        return None, te
    je = JaxEngine(jspec, jax.tree_util.tree_map(jnp.asarray, params), JaxLossConfig(**cfg), optimizer=optimizer,
                   learning_rate=lr, lbfgs_history=history, pack_stem=False)
    return je, te


def _inputs(t=6, hw=(24, 32), style_frames=(7,), seed=0):
    rng = np.random.default_rng(seed)
    content = rng.normal(0, 40, (1, *hw, 3)).astype(np.float32)
    styles = [rng.normal(0, 40, (n, 24, 28, 3)).astype(np.float32) for n in style_frames]
    init = rng.normal(0, 30, (t, *hw, 3)).astype(np.float32)
    return content, styles, init


def _small_inputs(seed):
    """tests/test_engine.py's inputs for the frozen split: pixels in [0, 1)
    and an init of 0.001·N(0, 1).  At the scale of real images L-BFGS's
    first curvature pair is float noise (its first step has length
    1/||g||_1), so two runners whose dot products run over vectors of other
    lengths (the whole window, the active slice) drift apart there."""
    rng = np.random.default_rng(seed)
    content = rng.random((1, 24, 32, 3)).astype(np.float32)
    styles = [rng.random((8, 24, 28, 3)).astype(np.float32)]
    return content, styles, rng.normal(0, 0.001, (8, 24, 32, 3)).astype(np.float32)


def _both(je, te, content, styles, init, n_iters, **kw):
    want = np.asarray(je.optimize(content, styles, init, n_iters, transfer_type="img_vid", **kw))
    got = te.optimize(content, styles, init, n_iters, transfer_type="img_vid", **kw)
    assert got.shape == want.shape == init.shape and got.dtype == np.float32
    np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)
    # float drift over a few optimiser steps, on pixels of about ±100
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    return got


def test_mixed_image_and_video_styles_match_jax():
    """A 7-frame style video and a style image (which adds no dynamic
    target), a 6-frame pastiche in windows of 3; the dynamic term is
    non-zero wherever the window holds 3 frames."""
    je, te = _engines()
    content, styles, init = _inputs(style_frames=(7, 1))
    out = _both(je, te, content, styles, init, 3, blend_weights=[0.7, 0.3], gram_frame_window=3)
    names = te.loss_cfg.loss_names()
    style_cols = [i for i, n in enumerate(names) if n.startswith("style:")]
    assert te.last_loss_log.shape == (3 * 3, len(names))  # 3 iterations in each of ceil(6 / 3) + 1 windows
    assert (te.last_loss_log[:, style_cols] > 0).all()
    assert np.abs(out - init).max() > 0.5


def test_one_frame_pastiche_matches_jax():
    """A 1-frame pastiche with gram_frame_window 4: every window is that one
    frame (the mask is sized to it), and no dynamic term applies."""
    je, te = _engines()
    content, styles, init = _inputs(t=1, style_frames=(6,))
    _both(je, te, content, styles, init, 3, gram_frame_window=4)
    assert te.last_loss_log.shape[0] == 3 * 2


def test_avg_frame_window_targets_match_jax(monkeypatch):
    """--avg_frame_window: each window's targets come from a 4-frame
    stretch of each style, starting where the schedule puts it."""
    je, te = _engines()
    content, styles, init = _inputs(style_frames=(9, 5))
    seen = []
    real = te.style_video_targets

    def spy(videos, bw, gfw):
        seen.append([np.shape(v)[0] for v in videos])
        return real(videos, bw, gfw)

    monkeypatch.setattr(te, "style_video_targets", spy)
    _both(je, te, content, styles, init, 2, blend_weights=[0.5, 0.5], gram_frame_window=3, avg_frame_window=4)
    assert seen == [[4, 4]] * 3


def test_temporal_target_matches_jax():
    """``optimize``'s ``temporal_target`` (an already warped target, with
    per-pixel weights), kept from the JAX signature beside img_vid's
    arguments."""
    je, te = _engines()
    content, _, init = _inputs(t=1)
    rng = np.random.default_rng(3)
    style = rng.normal(0, 40, (1, 24, 28, 3)).astype(np.float32)
    target = rng.normal(0, 30, init.shape).astype(np.float32)
    weights = rng.random((*init.shape[:3], 1)).astype(np.float32)
    kw = dict(temporal_target=target, temporal_weights=weights)
    want = np.asarray(je.optimize(content, [style], init, 3, **kw))
    got = te.optimize(content, [style], init, 3, **kw)
    np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)
    assert (te.last_loss_log[:, -1] > 0).all()  # the temporal column
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_frozen_split_matches_masked(monkeypatch, optimizer):
    """The frozen-split runner (frozen frames' activations extracted once,
    forward and backward on the active slice) against the masked runner
    over the whole window, as tests/test_engine.py holds the JAX one; the
    split also against JAX's."""
    content, styles, init = _small_inputs(1)
    outs = []
    for split in (False, True):
        monkeypatch.setattr(teo, "_WINDOW_SPLIT", split)
        _, te = _engines(optimizer, jax_too=False)
        calls = []
        real = te._run
        monkeypatch.setattr(te, "_run", lambda *a, **kw: calls.append(kw.get("frozen")) or real(*a, **kw))
        outs.append(te.optimize(content, styles, init, 3, transfer_type="img_vid", gram_frame_window=4))
        assert any(f is not None for f in calls) == split
    assert np.abs(outs[0] - init).max() > 1e-3
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)
    je, _ = _engines(optimizer)
    want = np.asarray(je.optimize(content, styles, init, 3, transfer_type="img_vid", gram_frame_window=4))
    np.testing.assert_allclose(outs[1], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("crash_at", [3, 4])
def test_checkpointed_window_run_resumes(tmp_path, monkeypatch, crash_at):
    """Chunks of 2 of 4 iterations: a crash in the 3rd chunk resumes from
    the end of window 0, one in the 4th from the middle of window 1.  A
    checkpointed run keeps the masked runner, so its saved optimizer state
    has the whole window's shape; the resumed run equals an uninterrupted
    checkpointed one exactly, and the frozen-split run within 2e-4."""
    content, styles, init = _small_inputs(2)
    kw = dict(transfer_type="img_vid", gram_frame_window=4, checkpoint_every=2)
    _, te = _engines("lbfgs", jax_too=False)
    want = te.optimize(content, styles, init, 4, run_checkpoint=str(tmp_path / "whole"), **kw)
    want_log = te.last_loss_log
    split = te.optimize(content, styles, init, 4, transfer_type="img_vid", gram_frame_window=4)
    np.testing.assert_allclose(split, want, rtol=2e-4, atol=2e-4)

    run_dir = str(tmp_path / "rs")
    _, te = _engines("lbfgs", jax_too=False)
    real, calls = te._run, []

    def crash(*a, **k):
        calls.append(k)
        if len(calls) == crash_at:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(te, "_run", crash)
    with pytest.raises(KeyboardInterrupt):
        te.optimize(content, styles, init, 4, run_checkpoint=run_dir, **kw)
    assert all(k["frozen"] is None for k in calls)
    saved = torch.load(os.path.join(run_dir, "state.pt"), weights_only=True)
    assert (saved["window"], saved["done_iters"]) == ((1, 0) if crash_at == 3 else (1, 2))
    assert saved["pastiche"]["pastiche"].shape == (4, 3, 24, 32)
    assert saved["pastiche"]["output"].shape == init.shape
    assert saved["opt_state"]["s_hist"].shape[1] == 4 * 3 * 24 * 32

    _, te = _engines("lbfgs", jax_too=False)
    got = te.optimize(content, styles, init, 4, run_checkpoint=run_dir, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(te.last_loss_log, want_log[-te.last_loss_log.shape[0]:])
    assert not os.path.exists(run_dir)


def _u8_drift(a: np.ndarray, b: np.ndarray) -> None:
    """The u8 drift bound of tests/test_pipeline_video.py: max <= 6, mean <=
    0.5, at most 2% of pixels past 2."""
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 6 and d.mean() <= 0.5 and (d > 2).mean() <= 0.02, (int(d.max()), float(d.mean()))


def test_img_vid_cli_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    content = np.stack([xx * 4 % 256, yy * 5 % 256, ((xx - 30) ** 2 + (yy - 20) ** 2 < 200) * 255], -1)
    Image.fromarray(content.astype(np.uint8)).save(tmp_path / "content.png")
    sy, sx = np.mgrid[0:40, 0:40]
    frames = [np.stack([np.sin((sx + 3 * t) / 3), np.cos((sy - 2 * t) / 4), np.sin((sx + sy) / 5)], -1) for t in range(5)]
    np.save(tmp_path / "sv.npy", ((np.stack(frames) * 0.5 + 0.5) * 255 + rng.integers(0, 8, (5, 40, 40, 3))).astype(np.uint8))
    npz = tmp_path / "vgg19.npz"
    save_npz_params(jax_init_params(jax_select_model("vgg19")), str(npz))

    def argv(out):
        return ["--transfer_type", "img_vid", "--content", str(tmp_path / "content.png"), "--style", str(tmp_path / "sv.npy"),
                "--output_dir", str(tmp_path / out), "--gpu", "c", "--model_file", str(npz), "--image_sizes", "32,48",
                "--num_iters", "3,2", "--num_frames", "4", "--gram_frame_window", "3,2", "--avg_frame_window", "4",
                "--optimizer", "adam", "--seed", "0", "--mesh", "space:1",
                "--style_layers", "relu1_1,relu2_1,relu3_1", "--content_layers", "relu3_1"]

    engines = {"jax": [], "torch": []}
    for key, module in (("jax", jax_img_vid), ("torch", torch_img_vid)):
        orig = module.build_engine
        monkeypatch.setattr(module, "build_engine", lambda args, size=None, orig=orig, key=key:
                            engines[key].append(orig(args, size)) or engines[key][-1])
    jax_style.main(argv("jax"))
    torch_style.main(argv("torch"))

    for stem in ("content_sv_32", "content_sv_48", "content_sv"):
        want = np.load(tmp_path / "jax" / f"{stem}.npy")
        got = np.load(tmp_path / "torch" / f"{stem}.npy")
        assert got.shape == ((4, 24, 32, 3) if stem.endswith("32") else (4, 36, 48, 3))
        _u8_drift(got, want)
        assert len(os.listdir(tmp_path / "torch" / f"{stem}_frames")) == 4
    for je, te in zip(engines["jax"], engines["torch"]):
        np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)

    # a re-run resumes both scales from their stacks
    capsys.readouterr()
    torch_style.main(argv("torch"))
    assert len(engines["torch"]) == 2 and "Current size" not in capsys.readouterr().out
