"""The port's clip_video_style (``pipelines/clip_video_style.py``) against
the JAX package's on the CPU.

- With a recording stand-in for the CLIP + VQGAN engine on both sides (as
  ``tests/test_clip_video.py`` has): the same ``update_styles`` calls, one
  a scale with that scale's style shapes (the styles within 1e-5), and
  every ``optimize_cached`` call handed the same other arguments (no mask,
  no styles) and the same content and init: the content within max|Δ| <=
  1e-4 in [0, 1] (float32 histogram matching: the two packages' colour
  transforms differ by up to 5e-3 of 255), the first pass's init within
  1e-4 too, a later pass's init, read back from the previous pass's u8
  PNG, within one u8 level (1/255) + 1e-4 (a float difference at a
  rounding boundary moves a pixel by one level).
- The boundary conversions equal exactly (the same numpy code).
- One real port run, ``--gpu c``, with a tiny VQGAN and CLIP and SPyNet:
  every pass's artifacts of every frame.

The flow nets read numpy-made weights from a modelzoo npz on both sides;
each test empties both packages' flow-net caches first, since JAX's caches a
net by its name alone (another test's random SPyNet would otherwise stand in
for this test's weights)."""

import glob

import numpy as np
import pytest
from PIL import Image

from maua_style_tpu import config as jax_config
from maua_style_tpu import flow as jax_flow
from maua_style_tpu.pipelines import clip_video_style as jax_cvs
from maua_style_tpu_torch import config, flow
from maua_style_tpu_torch.models import vqgan as vq
from maua_style_tpu_torch.models.clip import model as clip_model
from maua_style_tpu_torch.pipelines import clip_video_style as cvs
from maua_style_tpu_torch.pipelines import clip_vqgan as cv
from test_torch_clip_vqgan import TINY_CLIP, TINY_VQ
from test_torch_flownets_d import _write_modelzoo
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _inputs(d, n_frames, monkeypatch):
    monkeypatch.setattr(jax_flow, "_MODEL_CACHE", {})
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    rng = np.random.default_rng(0)
    np.save(str(d / "vid.npy"), rng.integers(0, 255, (n_frames, 24, 24, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)).save(str(d / "style.png"))
    _write_modelzoo(d, ["spynet"])


def _argv(d, out, sizes, iters, passes, init):
    return ["--content", str(d / "vid.npy"), "--style", str(d / "style.png"), "--style_text", "a watercolor painting",
            "--output_dir", str(d / out), "--image_sizes", sizes, "--num_iters", iters, "--passes_per_scale", passes,
            "--flow_models", "spynet", "--init", init, "--gpu", "c", "--scaling_args", str(d / "missing.json"),
            "--seed", "0"]


class _Recorder:
    """A stand-in engine that records what the pipeline hands it and
    returns the init clipped to [0, 1] (``tests/test_clip_video.py``'s)."""

    target_embeds = None

    def __init__(self):
        self.styles, self.calls = [], []

    def update_styles(self, styles, content_text, style_text):
        self.styles.append(([s.shape for s in styles], [np.asarray(s) for s in styles], content_text, style_text))
        return "embeds"

    def optimize_cached(self, **kw):
        self.calls.append(kw)
        return np.clip(kw["init"], 0.0, 1.0)


def test_engine_calls_match_jax(tmp_path, monkeypatch):
    """Two scales (12, 16), two passes, three frames, ``--init prev_warp``
    (the first pass warps the flow into the init)."""
    _inputs(tmp_path, 3, monkeypatch)
    monkeypatch.chdir(tmp_path)
    jax_rec, port_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(jax_cvs, "get_engine", lambda d, b: jax_rec)
    monkeypatch.setattr(cvs, "get_engine", lambda d, b, device=None: port_rec)
    jax_cvs.clip_video_style(jax_config.get_args(_argv(tmp_path, "jax", "12,16", "2,2", "2", "prev_warp")))
    cvs.clip_video_style(config.get_args(_argv(tmp_path, "port", "12,16", "2,2", "2", "prev_warp")))

    assert len(port_rec.styles) == len(jax_rec.styles) == 2
    for (gs, g, *gt), (ws, w, *wt) in zip(port_rec.styles, jax_rec.styles):
        assert gs == ws and gt == wt == [None, "a watercolor painting"]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert port_rec.styles[0][0] != port_rec.styles[1][0]
    assert len(port_rec.calls) == len(jax_rec.calls) == 2 * 2 * 3
    for got, want in zip(port_rec.calls, jax_rec.calls):
        assert got.keys() == want.keys()
        assert got["mask"] is None and got["styles"] is None
        for k in want:
            if k not in ("init", "content"):
                assert got[k] == want[k], k
        assert got["init"].shape == want["init"].shape == got["content"].shape == want["content"].shape
        np.testing.assert_allclose(got["content"], want["content"], atol=1e-4)
    for i, (got, want) in enumerate(zip(port_rec.calls, jax_rec.calls)):
        from_png = i >= 3  # every call after the first pass of the first scale
        np.testing.assert_allclose(got["init"], want["init"], atol=1e-4 + (1 / 255 if from_png else 0))
    # the artifacts of both runs: the same names
    port = sorted(p.replace(str(tmp_path / "port"), "") for p in glob.glob(str(tmp_path / "port" / "**" / "*.png"), recursive=True))
    jax = sorted(p.replace(str(tmp_path / "jax"), "") for p in glob.glob(str(tmp_path / "jax" / "**" / "*.png"), recursive=True))
    assert port == jax and len(port) >= 2 * 2 * 3


def test_boundary_conversions_equal():
    rng = np.random.default_rng(1)
    bgr = (rng.random((1, 9, 7, 3)).astype(np.float32) * 300 - 150).astype(np.float32)
    rgb01 = rng.random((1, 9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(cvs._bgr_to_rgb01(bgr), jax_cvs._bgr_to_rgb01(bgr))
    np.testing.assert_array_equal(cvs._rgb01_to_bgr(rgb01), jax_cvs._rgb01_to_bgr(rgb01))
    back = cvs._bgr_to_rgb01(cvs._rgb01_to_bgr(rgb01))
    np.testing.assert_allclose(back, rgb01, atol=1e-5)


def test_port_run_on_the_cpu(tmp_path, monkeypatch):
    """``--gpu c``, a tiny VQGAN and CLIP (seeded random weights), SPyNet,
    3 frames of 24², size 16, 2 passes of 4 iterations."""
    _inputs(tmp_path, 3, monkeypatch)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(vq, "load_vqgan", lambda d, s=0: vq.init_vqgan(vq.VQGANConfig(**TINY_VQ), 0))
    monkeypatch.setattr(cv, "_load_clip", lambda b: clip_model.init_clip(clip_model.CLIPConfig(**TINY_CLIP)))
    monkeypatch.setattr(cv, "_ENGINE", None)
    cvs.main(_argv(tmp_path, "out", "16", "4", "2", "content"))
    assert cv._ENGINE is not None and str(cv._ENGINE.device) == "cpu"
    out_dir = tmp_path / "out" / "vid_style"
    for p in (1, 2):
        files = sorted(glob.glob(str(out_dir / "16" / f"{p}_*.png")))
        assert len(files) == 3, files
        img = np.asarray(Image.open(files[0]))
        assert img.shape == (16, 16, 3) and img.std() > 0
    assert len(glob.glob(str(out_dir / "flow" / "*.flo"))) == 2 * 3  # both directions of 3 pairs, the last wrapping


def test_gpu_is_the_default(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="gpu c"):
        cvs.main(["--content", "x.npy", "--style", "s.png"])
