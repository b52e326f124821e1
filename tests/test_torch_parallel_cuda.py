"""Meshes on a card: one banded step on ``[cuda:0, cuda:0]``
against the unbanded step, for img_img and for a vid_img frame
(``optimize_frame`` with the temporal term), img_vid's windows on
frames:2 against unsharded, and K1 at the bands' shapes against its plain
version.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Without a CUDA device they skip: K1 has no CPU mode."""

import math

import numpy as np
import pytest
import torch

from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch import trace
from maua_style_tpu_torch.ops import gram as G
from maua_style_tpu_torch.parallel import build_mesh, spatial


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


# VGG-19's five style layers of a 1024² image in two bands of 512 rows
BAND_SHAPES = [(1, 64, 512 * 1024), (1, 128, 256 * 512), (1, 256, 128 * 256), (1, 512, 64 * 128), (1, 512, 32 * 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n", BAND_SHAPES)
def test_k1_at_band_shapes(b, c, n):
    _card()
    f = torch.relu(torch.randn(b, c, n, device="cuda"))
    got = G.gram(f)
    want = G.gram_reference(f)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    f64 = f.double()
    exact = torch.bmm(f64, f64.transpose(1, 2))
    assert float((got.double() - exact).abs().max() / exact.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("use_covariance", [False, True])
def test_banded_step_on_one_card_twice(use_covariance):
    """VGG-19 with the default layers at 168x96 (a ragged last band), TF32
    off, ``cudnn.deterministic``: the loss terms within 1e-5 relative, the
    gradient within 1e-4 of its max, and each style layer's Grams two K1
    launches."""
    _card()
    spec = select_model("vgg19")
    cfg = LossConfig(use_covariance=use_covariance)
    engine = StyleEngine(spec, init_params(spec, seed=0), cfg, device="cuda")
    gen = torch.Generator().manual_seed(0)
    h, w = 168, 96
    content = (torch.rand((1, h, w, 3), generator=gen) * 200 - 100).numpy()
    style = (torch.rand((1, 128, 128, 3), generator=gen) * 200 - 100).numpy()
    p = (torch.randn((1, 3, h, w), generator=gen) * 50).cuda()
    targets = {"content": engine.content_targets(content), "style": engine.style_targets([style], [1.0])}
    x = p.clone().requires_grad_(True)
    total, per = evaluate_losses(x, engine._extract(x, cfg.all_layers), targets, cfg)
    (grad,) = torch.autograd.grad(total, x)

    devices = [torch.device("cuda", 0)] * 2
    heights = spatial.band_rows(h, 2, 16)
    assert heights == [80, 88]
    bands = [b.requires_grad_(True) for b in spatial.split_rows(p, heights, devices, 3, w)]
    level = spatial.level_heights(heights, engine.spec, "relu4_2")
    banded = {"style": targets["style"], "content": {
        l: spatial.split_rows(t, level, devices, t.shape[1], t.shape[3]) for l, t in targets["content"].items()}}
    before = trace.counter("gram.launches")
    btotal, bper = evaluate_banded_losses(bands, engine._extract_bands(bands, cfg.all_layers), banded, cfg)
    assert trace.counter("gram.launches") - before == 2 * len(cfg.style_layers)
    bgrad = spatial.gather_rows(torch.autograd.grad(btotal, bands), heights, devices[0], 3, w)
    rel = ((bper - per).abs() / per.abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-5, (bper, per)
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-4
    assert math.isfinite(float(btotal))


@pytest.mark.cuda
def test_optimize_frame_step_on_one_card_twice():
    """``optimize_frame`` at 160x96 (two bands of 80 rows) from the
    ``warp_prev`` init with the temporal term and reliability weights,
    VGG-19 with the default layers, L-BFGS, TF32 off,
    ``cudnn.deterministic``: one step on ``[cuda:0, cuda:0]`` against
    unbanded, every loss term within rtol 1e-5 and the step within 1e-4 of
    its max; each style layer's Grams two K1 launches an iteration."""
    _card()
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    h, w = 160, 96
    u8 = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    style = rng.random((1, 128, 128, 3), np.float32) * 200 - 100
    prev = torch.from_numpy(rng.standard_normal((1, 3, h, w)).astype(np.float32) * 30).to(dev)
    kw = dict(out_hw=(h, w), blend_weights=[1.0], init_mode="warp_prev", prev=prev, use_temporal=True,
              flow=rng.standard_normal((h, w, 2)).astype(np.float32) * 3,
              weights_u8=rng.integers(0, 255, (h, w)).astype(np.uint8))

    def run(mesh, n):
        engine = StyleEngine(spec, params, LossConfig(), learning_rate=0.1, device=dev, mesh=mesh)
        engine.style_targets([style], [1.0])  # captured before the count
        before = trace.counter("gram.launches")
        p, _ = engine.optimize_frame(u8, [style], n, **kw)
        torch.cuda.synchronize()
        return p, engine.last_loss_log.cpu().numpy(), trace.counter("gram.launches") - before

    p0 = run(None, 0)[0]
    (q0, l0, n0), (q2, l2, n2) = run(None, 1), run(build_mesh([dev] * 2, [("space", 2)]), 1)
    assert (n0, n2) == (5, 10)
    assert l0[0, -1] > 0  # the temporal term is on
    np.testing.assert_allclose(l2, l0, rtol=1e-5, atol=0)
    assert float((q2 - q0).abs().max() / (q0 - p0).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_img_vid_windows_on_frames2_of_one_card():
    """img_vid on ``[cuda:0, cuda:0]`` frames:2 against unsharded: a 4-frame
    pastiche of 64x48 in windows of 4 (each window's frames 2 + 2), VGG-19
    with the default layers, video_style_factor 100, L-BFGS from 0.001·N(0,
    1), 3 iterations a window, TF32 off, ``cudnn.deterministic``: every
    total within rtol 1e-4 and each window's first two within 1e-5, mean|Δ|
    within 1e-2 of mean|p|; K1 10 launches an iteration a share (5 static
    Grams, 5 diagonal blocks of the whole-window Gram) after the target
    capture's 10."""
    _card()
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    content = rng.random((1, 64, 48, 3), np.float32) * 200 - 100
    video = rng.random((4, 64, 48, 3), np.float32) * 200 - 100
    init = rng.normal(0, 0.001, (4, 64, 48, 3)).astype(np.float32)

    def run(mesh):
        engine = StyleEngine(spec, params, LossConfig(video_style_factor=100.0), device=dev, mesh=mesh)
        before = trace.counter("gram.launches")
        out = engine.optimize(content, [video], init, 3, transfer_type="img_vid", gram_frame_window=4)
        torch.cuda.synchronize()
        return out, engine.last_loss_log, trace.counter("gram.launches") - before

    (p0, l0, n0), (p2, l2, n2) = run(None), run(build_mesh([dev] * 2, [("frames", 2)]))
    assert (n0, n2) == (10 + 2 * 3 * 10, 10 + 2 * 3 * 20)
    rtol = np.abs(l2.sum(axis=1) - l0.sum(axis=1)) / np.abs(l0.sum(axis=1))
    assert rtol.max() <= 1e-4 and rtol.reshape(2, 3)[:, :2].max() <= 1e-5, rtol
    assert np.abs(p2 - p0).mean() <= 1e-2 * np.abs(p0).mean()
