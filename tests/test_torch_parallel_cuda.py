"""The "space" mesh on a card: one banded step on ``[cuda:0, cuda:0]``
against the unbanded step, and K1 at the bands' shapes against its plain
version.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Without a CUDA device they skip: K1 has no CPU mode."""

import math

import pytest
import torch

from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.ops import gram as G
from maua_style_tpu_torch.parallel import spatial


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
    level = spatial.level_heights(heights, 8)
    banded = {"style": targets["style"], "content": {
        l: spatial.split_rows(t, level, devices, t.shape[1], t.shape[3]) for l, t in targets["content"].items()}}
    before = G.gram.launches
    btotal, bper = evaluate_banded_losses(bands, engine._extract_bands(bands, cfg.all_layers), banded, cfg)
    assert G.gram.launches - before == 2 * len(cfg.style_layers)
    bgrad = spatial.gather_rows(torch.autograd.grad(btotal, bands), heights, devices[0], 3, w)
    rel = ((bper - per).abs() / per.abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-5, (bper, per)
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-4
    assert math.isfinite(float(btotal))
