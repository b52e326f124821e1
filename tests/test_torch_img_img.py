"""The port's img_img CLI against the JAX package's, end to end at 32/48 px:
same inputs, same VGG-19 weights (the JAX init saved as vgg19.npz), same
seed, on the CPU."""

import importlib
import os

import numpy as np
import pytest
from PIL import Image

from maua_style_tpu import style as jax_style
from maua_style_tpu.models import init_params, select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu_torch import style as torch_style
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

# the JAX package's pipelines/__init__ re-exports the img_img function
# under the module's name
jax_img_img = importlib.import_module("maua_style_tpu.pipelines.img_img")
torch_img_img = importlib.import_module("maua_style_tpu_torch.pipelines.img_img")


def _write_inputs(d):
    yy, xx = np.mgrid[0:40, 0:60]
    content = np.stack([xx * 4 % 256, yy * 6 % 256, ((xx - 30) ** 2 + (yy - 20) ** 2 < 200) * 255], -1)
    Image.fromarray(content.astype(np.uint8)).save(d / "content.png")
    s = (np.sin(yy / 3) * 127 + 128).astype(np.uint8)
    Image.fromarray(np.stack([s, 255 - s, np.roll(s, 8, 0)], -1)).save(d / "style.png")


def _assert_u8_drift(a_path: str, b_path: str) -> None:
    """Artifact parity up to float drift (the bound of
    tests/test_pipeline_video.py:_assert_u8_drift): two frameworks sum in
    different orders, so a few pixels may cross an extra u8 rounding
    boundary.  max <= 6, mean <= 0.5, at most 2% of pixels past 2."""
    a = np.asarray(Image.open(a_path)).astype(int)
    b = np.asarray(Image.open(b_path)).astype(int)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max() <= 6, (a_path, b_path, int(d.max()), float(d.mean()))
    assert d.mean() <= 0.5, (a_path, b_path, float(d.mean()))
    assert (d > 2).mean() <= 0.02, (a_path, b_path, int((d > 2).sum()))


def _recording(monkeypatch, module, engines):
    orig = module.build_engine

    def build_engine(args, current_size=None):
        engine = orig(args, current_size)
        engines.append(engine)
        return engine

    monkeypatch.setattr(module, "build_engine", build_engine)


# L-BFGS runs without histogram matching: matching the 32 px result before
# the 48 px scale (an inverse square root of a nearly degenerate 3x3 colour
# covariance) turns a 1e-5 difference between the two runs into 1e-3 at the
# 48 px start, and L-BFGS's first curvature step — scaled by y.s / y.y from
# a first step of length 1/||g||_1, so y is near float noise — grows that to
# percent level.  Without matching both scales agree to about 1e-5; the Adam
# case keeps matching on, and tests/test_torch_io.py holds match_histogram
# itself to the JAX function.
@pytest.mark.parametrize("optimizer,extra", [("adam", ()), ("lbfgs", ("--no_hist_match",))])
def test_img_img_cli_matches_jax(tmp_path, monkeypatch, capsys, optimizer, extra):
    _write_inputs(tmp_path)
    npz = tmp_path / "vgg19.npz"
    save_npz_params(init_params(select_model("vgg19")), str(npz))

    def argv(out):
        return [
            "--content", str(tmp_path / "content.png"),
            "--style", str(tmp_path / "style.png"),
            "--output_dir", str(tmp_path / out),
            "--gpu", "c",
            "--model_file", str(npz),
            "--image_sizes", "32,48",
            "--num_iters", "4,3",
            "--seed", "0",
            "--optimizer", optimizer,
            # one CPU device: the suite's 8 virtual JAX devices would
            # otherwise shard the JAX run spatially
            "--mesh", "space:1",
            *extra,
        ]

    jax_engines, torch_engines = [], []
    _recording(monkeypatch, jax_img_img, jax_engines)
    _recording(monkeypatch, torch_img_img, torch_engines)
    jax_style.main(argv("jax"))
    torch_style.main(argv("torch"))

    for size in (32, 48):
        name = f"content_style_{size}.png"
        _assert_u8_drift(str(tmp_path / "jax" / name), str(tmp_path / "torch" / name))
    assert [e.last_loss_log.shape for e in torch_engines] == [(4, 8), (3, 8)]
    for je, te in zip(jax_engines, torch_engines):
        # the per-iteration losses of both runs; rtol 1e-3 leaves room for
        # float drift compounded over a few optimiser steps
        np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)

    # a re-run resumes from the artifacts and skips both scales
    capsys.readouterr()
    before = {s: os.path.getmtime(tmp_path / "torch" / f"content_style_{s}.png") for s in (32, 48)}
    torch_style.main(argv("torch"))
    assert len(torch_engines) == 2
    assert all(os.path.getmtime(tmp_path / "torch" / f"content_style_{s}.png") == t for s, t in before.items())
