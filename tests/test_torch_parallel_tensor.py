"""The "tensor" mesh axis on img_img (the port's ``parallel.mesh_grid`` and
``channel_shares``, ``spatial.conv_pieces``, ``split_pieces`` /
``gather_pieces``, ``ops.gram.channel_gram`` and
``losses.evaluate_banded_losses`` over (band, share) pieces), on meshes of
repeated CPU entries: the channel-split convolution against the whole one
(forward and ``gradcheck``, uneven shares, with and without bands), the
block Gram against ``gram_reference``, one VGG-19 step on "tensor" and
"space × tensor" against unsharded, JAX's
``test_tensor_axis_sharding_matches_single_device`` (tests/test_parallel.py:
117-139) against JAX's own GSPMD run and the port's unsharded one, the
style CLI with ``--mesh tensor:3`` against JAX's, run-state checkpoints
across layouts, tensor:4 over the 3 colour channels (an empty share), and
the banded decoder's refusal.

A share's convolution sums its input channels in another order than the
whole convolution (JAX's own test: "partial sums arrive via psum in a
different order"), so runs are held over a few iterations."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from maua_style_tpu import style as jax_style
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu.parallel import pastiche_sharding_for as jax_sharding_for
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine import optimize as optimize_module
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.models import vqgan as vq
from maua_style_tpu_torch.ops.gram import channel_gram, gram_reference
from maua_style_tpu_torch.parallel import build_mesh, channel_shares, mesh_grid, spatial
from test_parallel import _engine as jax_engine
from test_torch_img_img import _assert_u8_drift, torch_img_img
from test_torch_parallel import _small_engine, _write_inputs
from test_torch_parallel_video import _port_small
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CPU = torch.device("cpu")
TENSOR2, TENSOR3 = [("tensor", 2)], [("tensor", 3)]
SPACE2_TENSOR3 = [("space", 2), ("tensor", 3)]


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


# -- the grid and the shares ----------------------------------------------------------


def test_mesh_grid_reads_bands_and_shares():
    """``grid[i][t]``: band i of share t, for either axis order and under a
    "frames" axis (its first row); ``mesh_rows`` would read all six devices
    of space:2,tensor:3 as one row of bands."""
    devs = [torch.device("cpu", i) for i in range(12)]
    assert mesh_grid(build_mesh(devs[:6], SPACE2_TENSOR3)) == [tuple(devs[0:3]), tuple(devs[3:6])]
    assert mesh_grid(build_mesh(devs[:6], [("tensor", 3), ("space", 2)])) == [
        (devs[0], devs[2], devs[4]), (devs[1], devs[3], devs[5])]
    assert mesh_grid(build_mesh(devs[:12], [("frames", 2), *SPACE2_TENSOR3])) == [tuple(devs[0:3]), tuple(devs[3:6])]
    assert mesh_grid(build_mesh(devs[:2], TENSOR2)) == [(devs[0], devs[1])]
    assert mesh_grid(build_mesh(devs[:2], [("space", 2)])) == [(devs[0],), (devs[1],)]


def test_channel_shares_even_larger_first():
    def sizes(c, t):
        return [s.stop - s.start for s in channel_shares(c, t)]

    assert sizes(3, 2) == [2, 1] and sizes(3, 3) == [1, 1, 1] and sizes(64, 3) == [22, 21, 21]
    assert sizes(512, 3) == [171, 171, 170] and sizes(128, 2) == [64, 64]
    assert channel_shares(64, 3)[1] == slice(22, 43)
    assert sizes(3, 4) == [1, 1, 1, 0] and channel_shares(3, 4)[3] == slice(3, 3)  # GSPMD's padding: nothing


def test_tensor4_builds_and_steps_as_unsharded(vgg19, monkeypatch):
    """tensor:4 over the pastiche's 3 colour channels (1 + 1 + 1 + 0; 16
    channels a share past it) builds and takes one step within rtol 1e-5
    of unsharded (the terms; the gradient within 1e-5 of max|g|, as
    ``test_step_matches_unsharded``), and no convolution or Gram meets the
    empty share."""
    spec, params = vgg19
    cfg = LossConfig()
    rng = np.random.default_rng(7)
    content = rng.random((1, 64, 40, 3), np.float32) * 100
    style = rng.random((1, 48, 48, 3), np.float32) * 100
    p = torch.from_numpy(rng.standard_normal((1, 3, 64, 40)).astype(np.float32) * 50)
    one = StyleEngine(spec, params, cfg, device="cpu")
    style_t = one.style_targets([style], [1.0])
    x = p.clone().requires_grad_(True)
    total, per = evaluate_losses(x, one._extract(x, cfg.all_layers), {"content": one.content_targets(content),
                                                                      "style": style_t}, cfg)
    (grad,) = torch.autograd.grad(total, x)

    from maua_style_tpu_torch.ops import gram as gram_ops

    convs, grams = [], []
    conv2d, gram = spatial.F.conv2d, gram_ops.gram
    monkeypatch.setattr(spatial.F, "conv2d", lambda x, *a, **k: convs.append(x.shape[1]) or conv2d(x, *a, **k))
    monkeypatch.setattr(gram_ops, "gram", lambda f: grams.append(tuple(f.shape)) or gram(f))
    engine = StyleEngine(spec, params, cfg, device="cpu", mesh=_mesh([("tensor", 4)]))
    assert engine.shares == 4
    split, gather = engine._band_layout(p.shape)
    pieces = [b.requires_grad_(True) for b in split(p)]
    assert [b.shape[1] for b in pieces] == [1, 1, 1, 0]
    targets = {"content": engine.content_targets(content), "style": style_t}
    btotal, bper = evaluate_banded_losses(pieces, engine._extract_bands(pieces, cfg.all_layers), targets, cfg,
                                          shares=4)
    bgrad = gather([torch.zeros_like(b) if g is None else g
                    for b, g in zip(pieces, torch.autograd.grad(btotal, pieces, allow_unused=True))])
    assert convs and min(convs) >= 1 and grams and min(c for _, c, _ in grams) >= 1
    np.testing.assert_allclose(bper.detach().numpy(), per.detach().numpy(), rtol=1e-5, atol=0)
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-5


def test_split_and_gather_pieces_round_trip():
    grid = mesh_grid(_mesh(SPACE2_TENSOR3))
    heights, w = [16, 24], 5
    img = torch.arange(3 * 40 * w, dtype=torch.float32).reshape(1, 3, 40, w)
    pieces = spatial.split_pieces(img, heights, grid, 3, w)
    assert [tuple(p.shape) for p in pieces] == [(1, 1, 16, w), (1, 1, 24, w)] * 3
    assert torch.equal(pieces[3], img[:, 1:2, 16:])  # share 1, band 1
    assert torch.equal(spatial.gather_pieces(pieces, heights, 3, CPU, 3, w), img)
    hist = torch.stack([img.flatten(), -img.flatten()])  # (m, N), the L-BFGS layout
    rows = spatial.split_pieces(hist, heights, grid, 3, w)
    assert torch.equal(rows[3], torch.stack([pieces[3].flatten(), -pieces[3].flatten()]))
    assert torch.equal(spatial.gather_pieces(rows, heights, 3, CPU, 3, w), hist)


# -- the channel-split convolution ----------------------------------------------------------


def _convs(c_in, c_out, k, pad, n, dtype=torch.float64, bias=True):
    gen = torch.Generator().manual_seed(c_in * 100 + c_out)
    conv = torch.nn.Conv2d(c_in, c_out, k, 1, pad, bias=bias).to(dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, dtype=dtype))
        if bias:
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen, dtype=dtype))
    return conv.requires_grad_(False), [conv] * n


@pytest.mark.parametrize("shares, bands, c_in, c_out", [(2, 1, 3, 8), (3, 1, 3, 7), (3, 2, 8, 5), (2, 3, 5, 4)])
def test_conv_pieces_matches_conv(shares, bands, c_in, c_out):
    """The convolution of (band, share) pieces against the whole one, f64:
    forward within 1e-12 and ``gradcheck`` of every piece (uneven shares:
    3 → 2 + 1, 7 → 3 + 2 + 2, 5 → 2 + 2 + 1), the bias added once."""
    conv, convs = _convs(c_in, c_out, 3, 1, shares * bands)
    gen = torch.Generator().manual_seed(shares + bands)
    x = torch.randn((1, c_in, 4 * bands, 6), generator=gen, dtype=torch.float64)
    grid = [tuple([CPU] * shares)] * bands
    heights = [4] * bands
    pieces = [p.requires_grad_(True) for p in spatial.split_pieces(x, heights, grid, c_in, 6)]
    out = spatial.conv_pieces(convs, pieces, shares)
    assert [p.shape[1] for p in out[::bands]] == [s.stop - s.start for s in channel_shares(c_out, shares)]
    whole = spatial.gather_pieces(out, heights, shares, CPU, c_out, 6)
    torch.testing.assert_close(whole, conv(x), rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda *ps: tuple(spatial.conv_pieces(convs, ps, shares)), tuple(pieces))


def test_conv_pieces_strided_without_bias():
    """NIN's 11x11/4 conv1 (no padding, p = 0) on 2 shares of 2 bands,
    without bias, against the whole convolution."""
    conv = torch.nn.Conv2d(3, 6, 11, 4, 0, bias=False).double().requires_grad_(False)
    x = torch.randn((1, 3, 64, 19), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    heights = [32, 32]
    pieces = spatial.split_pieces(x, heights, [(CPU, CPU)] * 2, 3, 19)
    got = spatial.gather_pieces(spatial.conv_pieces([conv] * 4, pieces, 2), spatial.level_heights(
        heights, _nin_conv1(), "conv1"), 2, CPU, 6, conv(x).shape[3])
    torch.testing.assert_close(got, conv(x), rtol=1e-12, atol=1e-12)


def _nin_conv1():
    from maua_style_tpu_torch.models.extractor import truncate_spec

    return truncate_spec(select_model("nin"), ["conv1"])


# -- the block Gram --------------------------------------------------------------------------


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("shares, bands", [(2, 1), (3, 1), (3, 2)])
def test_channel_gram_matches_reference(use_covariance, shares, bands):
    """The (C, C) Gram assembled from the shares' blocks against
    ``gram_reference`` of the whole (1, 64, N) features (64 on 3 shares:
    22 + 21 + 21), centred by each channel's whole-image mean under
    ``use_covariance``, and its gradient (a random, asymmetric cotangent)
    against autograd of the reference: within 1e-6 relative, in norm
    (``test_window_gram_of_shares_matches_video_gram``'s bar: f32, bands
    and shares sum in another order)."""
    gen = torch.Generator().manual_seed(shares * 10 + bands)
    x = torch.relu(torch.randn((1, 64, 8 * bands, 12), generator=gen)).requires_grad_(True)
    w = torch.randn((1, 64, 64), generator=gen)
    f = x.reshape(1, 64, -1)
    if use_covariance:
        f = f - f.mean(dim=2, keepdim=True)
    want = gram_reference(f)
    (gwant,) = torch.autograd.grad(torch.sum(want * w), x)
    grid = [tuple([CPU] * shares)] * bands
    pieces = spatial.split_pieces(x, [8] * bands, grid, 64, 12)
    got = channel_gram([pieces[t * bands : (t + 1) * bands] for t in range(shares)], use_covariance)
    ggot = spatial.gather_pieces(torch.autograd.grad(torch.sum(got * w), pieces), [8] * bands, shares, CPU, 64, 12)
    assert got.shape == (1, 64, 64)
    got = got.detach()
    assert float(torch.linalg.norm(got - want.detach()) / torch.linalg.norm(want)) <= 1e-6
    assert float(torch.linalg.norm(ggot - gwant) / torch.linalg.norm(gwant)) <= 1e-6


# -- the engine -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vgg19():
    spec = select_model("vgg19")
    return spec, init_params(spec, seed=0)


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("axes", [TENSOR2, TENSOR3, SPACE2_TENSOR3], ids=["tensor2", "tensor3", "space2_tensor3"])
def test_step_matches_unsharded(vgg19, axes, use_covariance):
    """One step's loss terms and gradient, VGG-19 with the default layers,
    on (band, share) pieces of ``[cpu] * N`` against the unsharded step:
    the terms within rtol 1e-5 and the gradient within 1e-5 of max|g|
    (``test_banded_step_matches_unbanded``'s bars).  The engine's layout
    and its content targets are its own: share-major pieces on the grid."""
    spec, params = vgg19
    cfg = LossConfig(use_covariance=use_covariance)
    rng = np.random.default_rng(len(axes) + use_covariance)
    height, width = 64, 40
    content = rng.random((1, height, width, 3), np.float32) * 100
    style = rng.random((1, 48, 48, 3), np.float32) * 100
    p = torch.from_numpy(rng.standard_normal((1, 3, height, width)).astype(np.float32) * 50)
    one = StyleEngine(spec, params, cfg, device="cpu")
    style_t = one.style_targets([style], [1.0])
    x = p.clone().requires_grad_(True)
    total, per = evaluate_losses(x, one._extract(x, cfg.all_layers), {"content": one.content_targets(content),
                                                                      "style": style_t}, cfg)
    (grad,) = torch.autograd.grad(total, x)

    engine = StyleEngine(spec, params, cfg, device="cpu", mesh=_mesh(axes))
    assert engine.shares == dict(axes)["tensor"] and len(engine.grid) == dict(axes).get("space", 1)
    split, gather = engine._band_layout(p.shape)
    pieces = [b.requires_grad_(True) for b in split(p)]
    assert len(pieces) == int(np.prod([s for _, s in axes]))
    targets = {"content": engine.content_targets(content), "style": style_t}
    btotal, bper = evaluate_banded_losses(pieces, engine._extract_bands(pieces, cfg.all_layers), targets, cfg,
                                          shares=engine.shares)
    bgrad = gather(list(torch.autograd.grad(btotal, pieces)))
    per, bper = per.detach(), bper.detach()
    np.testing.assert_allclose(bper.numpy(), per.numpy(), rtol=1e-5, atol=0)
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-5


def _tensor_inputs():
    """JAX tests/test_parallel.py:117-139's inputs."""
    np.random.seed(2)
    content = np.random.rand(1, 16, 16, 3).astype(np.float32) * 100
    style = np.random.rand(1, 16, 16, 3).astype(np.float32) * 100
    init = np.random.randn(1, 16, 16, 3).astype(np.float32) * 0.001
    return content, style, init


@pytest.mark.parametrize("axes", [SPACE2_TENSOR3, TENSOR2], ids=["space2_tensor3", "tensor2"])
def test_tensor_axis_sharding_matches_single_device(axes):
    """JAX tests/test_parallel.py:117-139, ported: VGG-16 with JAX's
    weights, Adam at lr 0.1, 2 iterations; the port on ``axes`` of CPU
    entries against JAX's GSPMD run on the same axes of its virtual
    devices (channels sharded, P(None, "space", None, "tensor")) and
    against the port's unsharded run, at JAX's atol = rtol = 1e-3."""
    content, style, init = _tensor_inputs()
    n = int(np.prod([s for _, s in axes]))

    class Args:
        devices = jax.devices()[:n]
        mesh_shape = axes

    je = jax_engine(jax_sharding_for(Args()))
    want = np.asarray(je.optimize(content, [style], init.copy(), 2, blend_weights=[1.0]))
    single = _port_small(None).optimize(content, [style], init.copy(), 2, blend_weights=[1.0])
    engine = _port_small(_mesh(axes))
    assert engine.shares == dict(axes)["tensor"]
    got = engine.optimize(content, [style], init.copy(), 2, blend_weights=[1.0])
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got, single, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(engine.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)


def test_checkpoints_across_layouts(tmp_path, monkeypatch):
    """A run-state written on space:2,tensor:3 resumes unsharded and the
    other way round (both in the single-device layout), L-BFGS, and an
    interrupted run ends where an uninterrupted one does."""
    content, style, init = _tensor_inputs()
    save_state = optimize_module.save_state

    def save_and_stop(*a):
        save_state(*a)
        raise KeyboardInterrupt

    def engine(axes):
        return _small_engine(_mesh(axes) if axes else None, "lbfgs")

    want = engine(None).optimize(content, [style], init.copy(), 6, blend_weights=[1.0])
    for first, second in ((SPACE2_TENSOR3, None), (None, SPACE2_TENSOR3), (TENSOR2, TENSOR3)):
        ckpt = str(tmp_path / "runstate")
        with monkeypatch.context() as m, pytest.raises(KeyboardInterrupt):
            m.setattr(optimize_module, "save_state", save_and_stop)
            engine(first).optimize(content, [style], init.copy(), 6, blend_weights=[1.0], run_checkpoint=ckpt,
                                   checkpoint_every=3)
        assert os.path.isdir(ckpt)
        got = engine(second).optimize(content, [style], init.copy(), 6, blend_weights=[1.0], run_checkpoint=ckpt,
                                      checkpoint_every=3)
        assert not os.path.exists(ckpt)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_img_img_cli_tensor3_matches_jax(tmp_path, monkeypatch):
    """``--gpu c --mesh tensor:3`` on both CLIs, VGG-19's weights carried
    across in ``vgg19.npz``, at 48 and 64 px (4 and 3 L-BFGS iterations,
    no histogram matching, as ``test_img_img_cli_space2_matches_jax``):
    the port's three channel shares against JAX's three virtual devices,
    and against the port's own unsharded run, within that test's u8 drift
    bounds; each iteration's total loss against the unsharded run within
    rtol 1e-4 (the TV term, ≈ 0.2 of ≈ 1e6, follows the reordered
    convolution sums by up to 4e-4 of itself at two torch threads)."""
    _write_inputs(tmp_path)
    npz = tmp_path / "vgg19.npz"
    save_npz_params(jax_init_params(jax_select_model("vgg19")), str(npz))
    engines = []
    orig = torch_img_img.build_engine

    def build_engine(args, current_size=None):
        engines.append(orig(args, current_size))
        return engines[-1]

    monkeypatch.setattr(torch_img_img, "build_engine", build_engine)

    def argv(out, mesh):
        return ["--content", str(tmp_path / "content.png"), "--style", str(tmp_path / "style.png"),
                "--output_dir", str(tmp_path / out), "--gpu", "c", "--model_file", str(npz),
                "--image_sizes", "48,64", "--num_iters", "4,3", "--seed", "0", "--optimizer", "lbfgs",
                "--no_hist_match", "--scaling_args", str(tmp_path / "none.json"), "--mesh", mesh]

    jax_style.main(argv("jax", "tensor:3"))
    torch_style.main(argv("torch", "tensor:3"))
    torch_style.main(argv("single", "space:1"))
    assert [e.shares for e in engines] == [3, 3, 1, 1] and [e.grid for e in engines[:2]] == [[(CPU,) * 3]] * 2
    for split, single in zip(engines[:2], engines[2:]):
        np.testing.assert_allclose(split.last_loss_log.sum(axis=1), single.last_loss_log.sum(axis=1), rtol=1e-4)
    for size in (48, 64):
        name = f"content_style_{size}.png"
        _assert_u8_drift(str(tmp_path / "jax" / name), str(tmp_path / "torch" / name))
        _assert_u8_drift(str(tmp_path / "single" / name), str(tmp_path / "torch" / name))


# -- what still raises ------------------------------------------------------------------------


def test_decoder_raises_on_tensor():
    """The banded decoder (no JAX path decodes on a mesh) raises on a
    "tensor" axis, the one path that does (vid_img's passes and img_vid's
    windows run on it: tests/test_torch_parallel_tensor_video.py and
    tests/test_torch_parallel_tensor_windows.py)."""
    cfg = vq.VQGANConfig(embed_dim=8, n_embed=32, ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
                         resolution=16)
    model = vq.VQGAN(cfg)
    with pytest.raises(NotImplementedError, match="no JAX path decodes on a mesh"):
        spatial.banded_decode(model, torch.zeros((1, 8, 8, 8)), _mesh(TENSOR2))


def test_whole_shape_of_pieces():
    """``--normalize_weights`` reads each banded target's whole shape: on a
    (band, share) grid the channels sum over shares, the rows over bands."""
    pieces = [torch.zeros((1, c, h, 5)) for c in (2, 1) for h in (16, 24)]
    assert optimize_module._whole_shape(pieces, 2) == (1, 3, 40, 5)
    assert optimize_module._whole_shape(pieces[:2]) == (1, 2, 40, 5)


def test_conv_pieces_uses_its_weight_slices():
    """``share_weight`` keeps one contiguous W[:, share] per module and
    share, made again after the weights change in place."""
    conv, _ = _convs(4, 3, 3, 1, 1, dtype=torch.float32)
    a = spatial.share_weight(conv, slice(0, 2))
    assert a.is_contiguous() and torch.equal(a, conv.weight[:, :2])
    assert spatial.share_weight(conv, slice(0, 2)) is a
    with torch.no_grad():
        conv.weight.mul_(2)
    assert torch.equal(spatial.share_weight(conv, slice(0, 2)), conv.weight[:, :2])
    x = torch.randn(1, 4, 6, 6)
    y = spatial.conv_pieces([conv] * 2, spatial.split_pieces(x, [6], [(CPU, CPU)], 4, 6), 2)
    torch.testing.assert_close(torch.cat(y, dim=1), F.conv2d(x, conv.weight, conv.bias, 1, 1), rtol=1e-5, atol=1e-5)


def test_step_gradient_moves_as_a_one_ulp_witness(vgg19):
    """Why phase 6n holds the one-step gradient on "tensor" to twice the
    unsharded gradient's own difference at an input one f32 spacing off:
    at 256² of a smooth, u8-quantised image (chip_smoke.py's pattern) the
    shares' reordered channel sums move activations by their last bits and
    VGG-19's ReLUs and max-pools route the gradient by them at near-ties,
    so the gradient differs by more than 1e-4 of its max, as the unsharded
    gradient does between two inputs one f32 spacing apart (up or down,
    the larger); the loss terms still agree within rtol 1e-5, and the
    shares' gradient stays within twice the witness."""
    spec, params = vgg19
    cfg = LossConfig()
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    u8 = np.stack([(np.sin(xx / 9.0) * 0.5 + 0.5) * 255, yy, ((xx - 128) ** 2 + (yy - 100) ** 2 < 62 ** 2) * 200 + 30],
                  -1).astype(np.uint8).astype(np.float32)
    content = (u8 - np.float32(120))[None]
    style = np.ascontiguousarray(content[:, ::-1, ::-1])
    one = StyleEngine(spec, params, cfg, device="cpu")
    targets = {"content": one.content_targets(content), "style": one.style_targets([style], [1.0])}

    def grad(x):
        x = x.clone().requires_grad_(True)
        total, per = evaluate_losses(x, one._extract(x, cfg.all_layers), targets, cfg)
        return torch.autograd.grad(total, x)[0], per.detach()

    x = torch.from_numpy(np.ascontiguousarray(content.transpose(0, 3, 1, 2)))
    g0, per = grad(x)
    witness = max(float((grad(torch.nextafter(x, torch.full_like(x, towards)))[0] - g0).abs().max() / g0.abs().max())
                  for towards in (float("inf"), float("-inf")))

    two = StyleEngine(spec, params, cfg, device="cpu", mesh=_mesh(TENSOR2))
    split, gather = two._band_layout(x.shape)
    pieces = [p.requires_grad_(True) for p in split(x)]
    total, bper = evaluate_banded_losses(pieces, two._extract_bands(pieces, cfg.all_layers),
                                         {"content": two.content_targets(content), "style": targets["style"]}, cfg,
                                         shares=two.shares)
    got = float((gather(list(torch.autograd.grad(total, pieces))) - g0).abs().max() / g0.abs().max())
    np.testing.assert_allclose(bper.detach().numpy(), per.numpy(), rtol=1e-5, atol=0)
    assert witness > 1e-4 and got > 1e-4
    assert got <= 2 * witness, (got, witness)
