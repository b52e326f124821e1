"""The "tensor" mesh axis past the 3 colour channels and on vid_img's
passes, on meshes of repeated CPU entries.

- tensor:N with N above a layer's channel count: the shares past the last
  channel are empty (``parallel.channel_shares``: 3 on tensor:4 give 1 + 1
  + 1 + 0, as GSPMD's padding leaves the fourth device nothing), and every
  consumer does nothing for them: ``spatial.conv_pieces`` (f64 forward
  and ``gradcheck``), the pools of ``banded_forward``, ``split_pieces`` /
  ``gather_pieces`` of images and flat L-BFGS rows, L-BFGS's dot products
  and run-state checkpoints; the engine on tensor:4 against JAX's own
  tensor:4 run (tests/test_parallel.py's ``_engine``) and unsharded.
- vid_img's passes on "tensor", "space × tensor" and "frames × tensor":
  the per-frame Grams of a stack of channel shares (``ops.gram.
  channel_gram``: per frame, never one (B·C, B·C) Gram), the temporal term
  on pieces (its (1, 1, H, W) weights in bands on every share's device),
  a stack's per-frame losses and L-BFGS state, ``optimize_frame`` (each
  init mode, the temporal term on) and ``optimize_frames`` against JAX's
  GSPMD engine on ``P(..., "tensor")``, a "frames" row's replica on the
  row's own tensor mesh (never a row of bands), ``optimize_frame_chain``
  and the host path against unsharded, and the vid_img CLI with ``--mesh
  tensor:2`` against JAX's.

A share's convolution sums its input channels in another order than the
whole one, so runs are held to one step tightly and to a few iterations at
JAX's bar for "tensor" (1e-3)."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.losses import LossConfig as JaxLossConfig
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.parallel import build_mesh as jax_build_mesh
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import LBFGS, StyleEngine
from maua_style_tpu_torch.engine import optimize as optimize_module
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_frame_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, registry, select_model
from maua_style_tpu_torch.models.convert import params_from_jax
from maua_style_tpu_torch.models.extractor import Extractor
from maua_style_tpu_torch.ops.gram import batch_gram, channel_gram
from maua_style_tpu_torch.parallel import build_mesh, channel_shares, mesh_grid, spatial
from test_parallel import _engine as jax_engine
from test_torch_img_img import _assert_u8_drift
from test_torch_parallel_tensor import _tensor_inputs
from test_torch_parallel_video import _assert_near_jax, _frame_inputs, _frames_inputs, _port_small
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)
from test_torch_vid_img import _cli_argv, _cli_setup, _write_flow_artifacts

CPU = torch.device("cpu")
TENSOR2, TENSOR4 = [("tensor", 2)], [("tensor", 4)]
SPACE2_TENSOR2 = [("space", 2), ("tensor", 2)]
FRAMES2_TENSOR2 = [("frames", 2), ("tensor", 2)]


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


def _jax_sharding(axes):
    """JAX's plan for ``axes`` (its ``pastiche_sharding_for`` policy):
    "frames" on N, "space" on H, "tensor" on C of an NHWC pastiche."""
    n = int(np.prod([s for _, s in axes]))
    dims = {"frames": 0, "space": 1, "tensor": 3}
    spec = [None] * 4
    for a, _ in axes:
        spec[dims[a]] = a
    return NamedSharding(jax_build_mesh(jax.devices()[:n], axes), P(*spec))


# -- Part 0: shares past the last channel -------------------------------------------


def test_channel_shares_past_the_channels_are_empty():
    def sizes(c, t):
        return [s.stop - s.start for s in channel_shares(c, t)]

    assert sizes(3, 4) == [1, 1, 1, 0]
    assert sizes(2, 5) == [1, 1, 0, 0, 0] and sizes(3, 8)[3:] == [0] * 5
    assert channel_shares(3, 4)[3] == slice(3, 3) and sizes(64, 4) == [16] * 4


@pytest.mark.parametrize("bands, c_in, c_out, shares", [(1, 3, 3, 4), (2, 3, 3, 4), (2, 2, 5, 3)],
                         ids=["3to3_tensor4", "3to3_space2_tensor4", "2to5_space2_tensor3"])
def test_conv_pieces_with_empty_shares_matches_conv(bands, c_in, c_out, shares, monkeypatch):
    """A convolution whose input (3 on tensor:4: 1 + 1 + 1 + 0) and output
    shares are partly empty, against the whole one, f64: the forward within
    1e-12 and ``gradcheck`` of every piece; no ``F.conv2d`` sees an empty
    share, and an empty output share is an empty piece (no bias)."""
    gen = torch.Generator().manual_seed(c_in * 10 + c_out)
    conv = torch.nn.Conv2d(c_in, c_out, 3, 1, 1).double().requires_grad_(False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, dtype=torch.float64))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen, dtype=torch.float64))
    x = torch.randn((1, c_in, 4 * bands, 6), generator=gen, dtype=torch.float64)
    heights = [4] * bands
    grid = [tuple([CPU] * shares)] * bands
    pieces = [p.requires_grad_(True) for p in spatial.split_pieces(x, heights, grid, c_in, 6)]
    seen = []
    conv2d = F.conv2d
    monkeypatch.setattr(spatial.F, "conv2d", lambda x, *a, **k: seen.append(x.shape[1]) or conv2d(x, *a, **k))
    out = spatial.conv_pieces([conv] * len(pieces), pieces, shares)
    assert seen and min(seen) >= 1
    assert [p.shape[1] for p in out[::bands]] == [s.stop - s.start for s in channel_shares(c_out, shares)]
    torch.testing.assert_close(spatial.gather_pieces(out, heights, shares, CPU, c_out, 6), conv2d(x, conv.weight, conv.bias,
                                                                                                     1, 1),
                               rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda *ps: tuple(y for y in spatial.conv_pieces([conv] * len(ps), ps, shares)
                                                      if y.numel()), tuple(pieces))


def test_banded_forward_pools_empty_shares():
    """A narrow VGG (2 channels at relu1_1, 4 at relu2_1) on tensor:4 and
    space:2,tensor:4: its pools meet empty shares at every layer of the
    first block, and every wanted layer's pieces gather to the whole
    forward's activations (f64, 1e-12)."""
    spec = registry._vgg_spec("vgg19", [2, 2, "P", 4, 4, "P", 6], "max")
    ex = Extractor(spec, init_params(spec, seed=1)).double()
    x = torch.randn((1, 3, 16, 8), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    wanted = ["relu1_2", "relu2_1", "relu3_1"]
    want = ex(x, wanted)
    for bands in (1, 2):
        heights = [8, 8] if bands == 2 else [16]
        grid = [tuple([CPU] * 4)] * bands
        got = spatial.banded_forward([ex] * 4 * bands, spatial.split_pieces(x, heights, grid, 3, 8), wanted, 4)
        assert [p.shape[1] for p in got["relu1_2"][::bands]] == [1, 1, 0, 0]
        for l in wanted:
            level = spatial.level_heights(heights, spec, l)
            whole = spatial.gather_pieces(got[l], level, 4, CPU, want[l].shape[1], want[l].shape[3])
            torch.testing.assert_close(whole, want[l], rtol=1e-12, atol=1e-12)


def test_split_and_gather_pieces_round_trip_an_empty_piece():
    """An image and a flat (m, N) history on space:2,tensor:4 over 3
    channels (one empty share a band): the pieces' shapes, and back, bit
    for bit."""
    grid = mesh_grid(_mesh([("space", 2), *TENSOR4]))
    heights, w = [16, 8], 5
    img = torch.arange(3 * 24 * w, dtype=torch.float32).reshape(1, 3, 24, w)
    pieces = spatial.split_pieces(img, heights, grid, 3, w)
    assert [tuple(p.shape) for p in pieces] == [(1, 1, 16, w), (1, 1, 8, w)] * 3 + [(1, 0, 16, w), (1, 0, 8, w)]
    assert torch.equal(spatial.gather_pieces(pieces, heights, 4, CPU, 3, w), img)
    hist = torch.stack([img.flatten(), -img.flatten(), img.flatten() * 2])
    rows = spatial.split_pieces(hist, heights, grid, 3, w)
    assert [tuple(r.shape) for r in rows[-2:]] == [(3, 0), (3, 0)]
    assert torch.equal(rows[2], torch.stack([pieces[2].flatten(), -pieces[2].flatten(), pieces[2].flatten() * 2]))
    assert torch.equal(spatial.gather_pieces(rows, heights, 4, CPU, 3, w), hist)


@pytest.mark.parametrize("method", ["compact", "two_loop"])
def test_lbfgs_over_pieces_with_an_empty_piece(method):
    """L-BFGS over tensor:4's pieces of a quadratic (one piece empty): its
    dot products add nothing for the empty piece, so the iterates equal the
    whole problem's."""
    gen = torch.Generator().manual_seed(5)
    curv = torch.rand((1, 3, 6, 5), generator=gen) + 0.5
    x0 = torch.randn((1, 3, 6, 5), generator=gen)
    grid = [tuple([CPU] * 4)]
    opt = LBFGS(0.5, 4, method=method)
    pieces, cp = spatial.split_pieces(x0, [6], grid, 3, 5), spatial.split_pieces(curv, [6], grid, 3, 5)
    state, whole = opt.init(pieces), x0.clone()
    wstate = opt.init(whole)
    assert [tuple(v.shape) for v in state["s_hist"]][-1] == (4, 0)
    for _ in range(6):
        upd, state = opt.update([k * p for k, p in zip(cp, pieces)], state)
        pieces = [p + u for p, u in zip(pieces, upd)]
        u, wstate = opt.update(curv * whole, wstate)
        whole = whole + u
    torch.testing.assert_close(spatial.gather_pieces(pieces, [6], 4, CPU, 3, 5), whole, rtol=1e-5, atol=1e-7)


def test_tensor4_matches_jax():
    """JAX tests/test_parallel.py:117-139's run (VGG-16 with JAX's weights,
    Adam at lr 0.1, 2 iterations at 16²) on tensor:4: the port's four
    shares of ``[cpu] * 4`` (the pastiche's 1 + 1 + 1 + 0, every later
    layer's 16 a share) against JAX's GSPMD run on four virtual devices
    (P(None, None, None, "tensor")) and the port's unsharded run, at JAX's
    atol = rtol = 1e-3."""
    content, style, init = _tensor_inputs()
    want = np.asarray(jax_engine(_jax_sharding(TENSOR4)).optimize(content, [style], init.copy(), 2, blend_weights=[1.0]))
    single = _port_small(None).optimize(content, [style], init.copy(), 2, blend_weights=[1.0])
    engine = _port_small(_mesh(TENSOR4))
    assert engine.shares == 4
    got = engine.optimize(content, [style], init.copy(), 2, blend_weights=[1.0])
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got, single, atol=1e-3, rtol=1e-3)


def test_tensor4_checkpoint_resumes_unsharded(tmp_path, monkeypatch):
    """A run-state written on tensor:4 (its empty share's L-BFGS rows
    gathered into the single-device layout) resumes unsharded, and the
    other way round; both end within 1e-3 of the uninterrupted unsharded
    run."""
    from test_torch_parallel import _small_engine

    content, style, init = _tensor_inputs()
    save_state = optimize_module.save_state

    def save_and_stop(*a):
        save_state(*a)
        raise KeyboardInterrupt

    def engine(axes):
        return _small_engine(_mesh(axes) if axes else None, "lbfgs")

    want = engine(None).optimize(content, [style], init.copy(), 6, blend_weights=[1.0])
    for first, second in ((TENSOR4, None), (None, TENSOR4)):
        ckpt = str(tmp_path / "runstate")
        with monkeypatch.context() as m, pytest.raises(KeyboardInterrupt):
            m.setattr(optimize_module, "save_state", save_and_stop)
            engine(first).optimize(content, [style], init.copy(), 6, blend_weights=[1.0], run_checkpoint=ckpt,
                                   checkpoint_every=3)
        got = engine(second).optimize(content, [style], init.copy(), 6, blend_weights=[1.0], run_checkpoint=ckpt,
                                      checkpoint_every=3)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


# -- Part 1: the per-frame Grams and the temporal term on pieces ----------------------


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("shares, bands", [(2, 1), (3, 2)], ids=["tensor2", "space2_tensor3"])
def test_stacked_channel_gram_is_per_frame(shares, bands, use_covariance):
    """``channel_gram`` of a stack of B = 3 frames cut into channel shares
    (10 on 3 shares: 4 + 3 + 3) and row bands: (B, C, C), each frame's own
    Gram, against ``batch_gram`` of the whole stack within 1e-6 relative in
    norm, and its gradient (a random cotangent); the window view of the
    stack would give one (B·C, B·C) Gram, which it is not."""
    gen = torch.Generator().manual_seed(shares * 10 + bands)
    x = torch.relu(torch.randn((3, 10, 6 * bands, 7), generator=gen)).requires_grad_(True)
    w = torch.randn((3, 10, 10), generator=gen)
    want = batch_gram(x, use_covariance)
    (gwant,) = torch.autograd.grad(torch.sum(want * w), x)
    heights = [6] * bands
    pieces = spatial.split_pieces(x, heights, [tuple([CPU] * shares)] * bands, 10, 7)
    got = channel_gram(spatial.columns(pieces, shares), use_covariance)
    assert got.shape == (3, 10, 10) != (3 * 10, 3 * 10)
    ggot = spatial.gather_pieces(torch.autograd.grad(torch.sum(got * w), pieces), heights, shares, CPU, 10, 7)
    got, want = got.detach(), want.detach()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-6
    assert float(torch.linalg.norm(ggot - gwant) / torch.linalg.norm(gwant)) <= 1e-6
    cross = float(torch.linalg.norm(want[1] - want[0]) / torch.linalg.norm(want[0]))
    assert cross > 1e-2  # the frames' Grams differ: a pooled Gram would not pass


def _temporal_cfg(normalize):
    return LossConfig(content_layers=(), style_layers=(), tv_weight=0.0, temporal_weight=50.0,
                      normalize_gradients=normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_temporal_term_on_pieces_matches_unbanded(weighted, normalize):
    """``evaluate_banded_losses``' temporal term on space:2,tensor:2's
    pieces (the engine's ``_temporal_targets``: the target cut as the
    pastiche, the (1, 1, H, W) weights in row bands on every share's
    device), f64, against ``evaluate_losses``' term: the value and the
    gradient (normalised or not), and a gradcheck of the unnormalised
    term."""
    gen = torch.Generator().manual_seed(3)
    h, w = 32, 6
    p = torch.randn((1, 3, h, w), generator=gen, dtype=torch.float64)
    target = torch.randn((1, 3, h, w), generator=gen, dtype=torch.float64)
    weights = torch.rand((1, 1, h, w), generator=gen, dtype=torch.float64) if weighted else None
    cfg = _temporal_cfg(normalize)
    whole = p.clone().requires_grad_(True)
    want, want_per = evaluate_losses(whole, {}, {"temporal": {"target": target, **({"weights": weights} if weighted
                                                                                    else {})}}, cfg)
    (gw,) = torch.autograd.grad(want, whole)
    spec = registry._vgg_spec("vgg19", [4, "P", 4], "max")
    engine = StyleEngine(spec, init_params(spec), cfg, device="cpu", mesh=_mesh(SPACE2_TENSOR2))
    tb = engine._temporal_targets(target, weights)
    if weighted:
        assert [tuple(b.shape) for b in tb["weights"]] == [(1, 1, 16, w)] * 4
    split, gather = engine._band_layout(p.shape)

    def banded(*bs):
        return evaluate_banded_losses(list(bs), {}, {"temporal": tb}, cfg, shares=2)

    pieces = [b.requires_grad_(True) for b in split(p)]
    got, got_per = banded(*pieces)
    torch.testing.assert_close(got_per, want_per, rtol=1e-12, atol=0)
    torch.testing.assert_close(gather(list(torch.autograd.grad(got, pieces))), gw, rtol=1e-10, atol=1e-12)
    if not normalize:
        assert torch.autograd.gradcheck(lambda *bs: banded(*bs)[0], tuple(pieces))


def test_frame_losses_on_pieces_keep_frames_apart():
    """``evaluate_frame_losses`` of a stack of 3 frames on tensor:2's pieces
    (``shares=2``): each frame's values and gradient as the unsharded
    stack's (its own content and temporal targets, one style target, each
    frame's terms normalised on their own, its Grams its own)."""
    spec = select_model("vgg16", "max")
    cfg = LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), temporal_weight=50.0)
    engine = StyleEngine(spec, init_params(spec, seed=0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    b, h, w = 3, 12, 10
    x = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40)
    content = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40)
    target = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40)
    weights = torch.from_numpy(rng.random((1, 1, h, w)).astype(np.float32))
    style = rng.random((1, 16, 16, 3), np.float32) * 100
    targets = {"style": engine.style_targets([style], [1.0]), "temporal": {"target": target, "weights": weights},
               "content": {l: a for l, a in engine._extract(content, cfg.content_layers).items()}}
    whole = x.clone().requires_grad_(True)
    want, want_per = evaluate_frame_losses(whole, engine._extract(whole, cfg.all_layers), targets, cfg)
    (gw,) = torch.autograd.grad(want, whole)

    two = StyleEngine(spec, init_params(spec, seed=0), cfg, device="cpu", mesh=_mesh(TENSOR2))
    split, gather = two._band_layout(x.shape)
    pieces = [t.requires_grad_(True) for t in split(x)]
    assert [tuple(p.shape) for p in pieces] == [(b, 2, h, w), (b, 1, h, w)]
    ptargets = {"style": targets["style"], "content": two._content_targets(content),
                "temporal": two._temporal_targets(target, weights)}
    got, got_per = evaluate_frame_losses(pieces, two._extract_bands(pieces, cfg.all_layers), ptargets, cfg, shares=2)
    assert got_per.shape == (b, len(cfg.loss_names()))
    np.testing.assert_allclose(got_per.detach().numpy(), want_per.detach().numpy(), rtol=1e-5, atol=0)
    gp = gather(list(torch.autograd.grad(got, pieces)))
    assert float((gp - gw).abs().max() / gw.abs().max()) <= 1e-5


@pytest.mark.parametrize("method", ["compact", "two_loop"])
def test_lbfgs_frames_over_pieces_share_no_state(method):
    """Two frames cut into space:2,tensor:2's pieces, on quadratics whose
    curvatures differ 100-fold: each frame's iterates equal its own
    unsharded single-problem run (``LBFGS(frames=True)`` sums each frame's
    dot products over the pieces, never over the frames)."""
    gen = torch.Generator().manual_seed(4)
    c, h, w, heights = 3, 8, 5, [3, 5]
    grid = [(CPU, CPU)] * 2
    curv = torch.stack([torch.rand((c, h, w), generator=gen) + 0.5, (torch.rand((c, h, w), generator=gen) + 0.5) * 100])
    x0 = torch.randn((2, c, h, w), generator=gen)
    frames_opt = LBFGS(0.5, 4, method=method, frames=True)
    pieces = spatial.split_pieces(x0, heights, grid, c, w)
    cp = spatial.split_pieces(curv, heights, grid, c, w)
    state = frames_opt.init(pieces)
    assert [tuple(v.shape) for v in state["s_hist"]] == [(2, 4, 2 * 3 * w), (2, 4, 2 * 5 * w), (2, 4, 3 * w),
                                                         (2, 4, 5 * w)]
    singles = [x0[i : i + 1].clone() for i in range(2)]
    single_opt = LBFGS(0.5, 4, method=method)
    single_states = [single_opt.init(s) for s in singles]
    for _ in range(8):
        upd, state = frames_opt.update([k * p for k, p in zip(cp, pieces)], state)
        pieces = [p + u for p, u in zip(pieces, upd)]
        for i in range(2):
            u, single_states[i] = single_opt.update(curv[i : i + 1] * singles[i], single_states[i])
            singles[i] = singles[i] + u
    got = spatial.gather_pieces(pieces, heights, 2, CPU, c, w)
    for i in range(2):
        torch.testing.assert_close(got[i : i + 1], singles[i], rtol=1e-4, atol=1e-6)
    assert float(got.abs().max()) < 0.5 * float(x0.abs().max())


# -- Part 1: the engine's frame paths against JAX's sharded engine ----------------------------


def _frame_cfg(cls):
    return cls(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), tv_weight=1e-3, temporal_weight=50.0,
               normalize_gradients=True)


def _jax_frame_engine(sharding):
    """tests/test_parallel.py's ``_engine`` with the temporal term on."""
    spec = jax_select_model("vgg16", "max")
    return JaxEngine(spec, jax_init_params(spec, seed=0), _frame_cfg(JaxLossConfig), optimizer="adam",
                     learning_rate=0.1, pastiche_sharding=sharding, pack_stem=False)


def _port_frame_engine(mesh):
    params = params_from_jax(jax_init_params(jax_select_model("vgg16", "max"), seed=0))
    return StyleEngine(select_model("vgg16", "max"), params, _frame_cfg(LossConfig), optimizer="adam",
                       learning_rate=0.1, device="cpu", mesh=mesh)


def _jax_noise(self, seed, out_hw):
    """JAX's random init (its frame program's 0.001·N(0, 1) threefry draw
    from PRNGKey(seed)), as the port's ``_noise`` hands it over."""
    x = np.asarray(0.001 * jax.random.normal(jax.random.PRNGKey(int(seed)), (1, *out_hw, 3), jnp.float32))
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(self.device)


@pytest.mark.parametrize("init_mode", ["content", "random", "warp_prev", "blend"])
def test_optimize_frame_on_tensor2_matches_jax(init_mode, monkeypatch):
    """``optimize_frame`` with the temporal term (the previous frame warped
    whole, reliability weights) on tensor:2 of ``[cpu, cpu]`` against JAX's
    frame program on ``P(None, None, None, "tensor")`` over two virtual
    devices and against the port unsharded, from each init (random: JAX's
    draw handed to both): VGG-16 with JAX's weights, Adam at lr 0.1, 3
    iterations at 16²; the pastiches at ``_assert_near_jax``'s bars, the
    loss logs within rtol 1e-3 and the displays within one level."""
    x = _frame_inputs(h=16, w=16)
    prev = x["prev"].numpy().transpose(0, 2, 3, 1)
    kw = dict(out_hw=(16, 16), blend_weights=[1.0], init_mode=init_mode, flow=x["flow"],
              weights_u8=x["weights_u8"], use_temporal=True, blend=x["blend"], temporal_blend=0.5, seed=3)
    style = x["style"][:, :16, :16]
    je = _jax_frame_engine(_jax_sharding(TENSOR2))
    jp, jd = je.optimize_frame(x["u8"], [style], 3, prev=jnp.asarray(prev), **kw)
    jp, jd, jl = np.asarray(jp), np.asarray(jd).astype(int), np.asarray(je.last_loss_log)
    monkeypatch.setattr(StyleEngine, "_noise", _jax_noise)
    single = _port_frame_engine(None)
    p0, d0 = single.optimize_frame(x["u8"], [style], 3, prev=prev, **kw)
    engine = _port_frame_engine(_mesh(TENSOR2))
    assert engine.shares == 2
    tp, td = engine.optimize_frame(x["u8"], [style], 3, prev=prev, **kw)
    log = engine.last_loss_log.numpy()
    assert log.shape == jl.shape == (3, 5) and log[:, -1].min() > 0  # the temporal term is on
    np.testing.assert_allclose(log, jl, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(log, single.last_loss_log.numpy(), rtol=1e-3, atol=1e-6)
    _assert_near_jax(tp.numpy().transpose(0, 2, 3, 1), jp)
    _assert_near_jax(tp.numpy(), p0.numpy())
    assert np.abs(td.numpy().astype(int) - jd).max() <= 1
    assert np.abs(td.numpy().astype(int) - d0.numpy().astype(int)).max() <= 1


@pytest.mark.parametrize("axes", [SPACE2_TENSOR2, FRAMES2_TENSOR2], ids=["space2_tensor2", "frames2_tensor2"])
def test_optimize_frame_on_combined_meshes_matches_jax(axes):
    """``optimize_frame`` from the warp_prev init (the temporal term on) on
    space:2,tensor:2 (two bands of two shares) and frames:2,tensor:2 (the
    first row's two shares: the per-frame program runs frames-stripped)
    against JAX's program on the same mesh and unsharded, as above, at
    32x16 (two bands of 16 rows): the loss logs within rtol 1e-3 of both,
    the pastiche at ``_assert_near_jax``'s bars against JAX's unsharded run
    and within 1e-2 mean|Δ| of mean|p| against its sharded one.  Adam's
    first steps are sign(g), and JAX's own space:2,tensor:2 run flips 31 of
    these 1536 entries by up to 0.31 (whole steps at float-noise gradient
    entries) from its unsharded run, where the port's lies within 3e-4."""
    x = _frame_inputs(h=32, w=16, seed=2)
    prev = x["prev"].numpy().transpose(0, 2, 3, 1)
    kw = dict(out_hw=(32, 16), blend_weights=[1.0], init_mode="warp_prev", flow=x["flow"],
              weights_u8=x["weights_u8"], use_temporal=True)
    style = x["style"][:, :16, :16]
    want = {}
    for key, sharding in (("single", None), ("sharded", _jax_sharding(axes))):
        je = _jax_frame_engine(sharding)
        jp, _ = je.optimize_frame(x["u8"], [style], 3, prev=jnp.asarray(prev), **kw)
        want[key] = (np.asarray(jp), np.asarray(je.last_loss_log))
    engine = _port_frame_engine(_mesh(axes))
    assert engine.shares == 2 and len(engine.grid) == dict(axes).get("space", 1)
    tp, _ = engine.optimize_frame(x["u8"], [style], 3, prev=prev, **kw)
    got = tp.numpy().transpose(0, 2, 3, 1)
    for _, log in want.values():
        np.testing.assert_allclose(engine.last_loss_log.numpy(), log, rtol=1e-3, atol=1e-6)
    _assert_near_jax(got, want["single"][0])
    assert np.abs(got - want["sharded"][0]).mean() <= 1e-2 * np.abs(want["sharded"][0]).mean()


@pytest.mark.parametrize("axes", [TENSOR2, FRAMES2_TENSOR2], ids=["tensor2", "frames2_tensor2"])
def test_optimize_frames_on_tensor_meshes_match_jax(axes, monkeypatch):
    """JAX tests/test_parallel.py:185-213's inputs (4 frames, content init,
    Adam lr 0.1, 5 iterations): the port on ``axes`` of CPU entries against
    JAX's ``optimize_frames`` under P(None, None, None, "tensor") or
    P("frames", None, None, "tensor") and against the port unsharded, at
    ``test_optimize_frames_matches_jax_sharded``'s bars.  Each row's step
    runs on channel shares of its frames, (B/F, C_t, H, W) pieces, never on
    row bands: on frames:2,tensor:2 each row's two "tensor" devices hold
    the colour channels 2 + 1 of its two frames."""
    contents, style, kw = _frames_inputs()
    je = jax_engine(_jax_sharding(axes))
    jp, jd = je.optimize_frames(contents, [style], 5, **kw)
    jp, jd, jl = np.asarray(jp), np.asarray(jd).astype(int), np.asarray(je.last_loss_log)
    p0, d0 = _port_small(None).optimize_frames(contents, [style], 5, **kw)
    steps = []
    orig = StyleEngine._steps

    def recording(self, pastiche, *a, **k):
        steps.append((self.shares, [tuple(p.shape) for p in pastiche]))
        return orig(self, pastiche, *a, **k)

    monkeypatch.setattr(StyleEngine, "_steps", recording)
    engine = _port_small(_mesh(axes))
    tp, td = engine.optimize_frames(contents, [style], 5, **kw)
    per_row = 4 // dict(axes).get("frames", 1)
    assert steps == [(2, [(per_row, 2, 20, 20), (per_row, 1, 20, 20)])] * dict(axes).get("frames", 1)
    assert tp.shape == (4, 1, 3, 20, 20) and engine.last_loss_log.shape == jl.shape == (4, 5, 4)
    np.testing.assert_allclose(engine.last_loss_log.numpy(), jl, rtol=1e-4, atol=0)
    _assert_near_jax(tp.numpy().transpose(0, 1, 3, 4, 2), jp)
    _assert_near_jax(tp.numpy(), p0.numpy())
    assert np.abs(td.numpy().astype(int) - jd).max() <= 1
    assert np.abs(td.numpy().astype(int) - d0.numpy().astype(int)).max() <= 1


def test_frames_row_replica_splits_channels(monkeypatch):
    """What ``--gpu 0,1,2,3 --mesh frames:2,tensor:2`` runs: the second
    row's share on a replica whose mesh is the row's own tensor:2
    (``parallel.row_mesh``), two channel shares and no bands, not a
    "space" mesh of the row's two devices (which would split rows and
    give a plausible answer).  On ``[cpu] * 4`` the second row is the
    engine's own, so it is looked up here as on distinct cards; the result
    against unsharded at JAX's bars."""
    contents, style, kw = _frames_inputs()
    single = _port_small(None)
    p0, _ = single.optimize_frames(contents, [style], 5, **kw)
    engine = _port_small(_mesh(FRAMES2_TENSOR2))
    replica_of = StyleEngine._replica
    rows = []

    def as_on_distinct_cards(self, row):
        if self is engine and len(row) > 1:  # optimize_frames' lookup of a row
            rows.append(row)
            if len(rows) == 2:  # the second row's, with the engine's own row hidden
                own, self.shares = self.shares, 1
                try:
                    return replica_of(self, row)
                finally:
                    self.shares = own
        return replica_of(self, row)

    monkeypatch.setattr(StyleEngine, "_replica", as_on_distinct_cards)
    tp, _ = engine.optimize_frames(contents, [style], 5, **kw)
    (key, replica), = engine._replicas.items()
    assert replica.mesh.axes == (("tensor", 2),) and replica.shares == 2 and replica.band_devices is None
    assert replica.grid == [key]
    _assert_near_jax(tp.numpy(), p0.numpy())
    np.testing.assert_allclose(engine.last_loss_log.numpy(), single.last_loss_log.numpy(), rtol=1e-4, atol=0)


def test_optimize_frame_chain_and_host_path_tensor2():
    """``optimize_frame_chain`` (two chained frames: the blend init and the
    temporal target) and the host path ``optimize(transfer_type=
    "vid_img", temporal_warp=...)`` on tensor:2 against unsharded, two
    L-BFGS iterations a frame at lr 0.1 (VGG-19, the default layers):
    ``test_optimize_frame_chain_and_host_path_space2``'s bars (loss logs
    within rtol 1e-5, outputs within 1e-2 mean|Δ| of mean|p|, displays
    within a mean of 0.5 levels)."""
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    x = _frame_inputs()
    rng = np.random.default_rng(1)
    aux = {"content_u8": np.stack([x["u8"], x["blend"]]), "blend": np.stack([x["blend"], x["u8"]]),
           "flow": np.stack([x["flow"], x["flow"][::-1].copy()]), "weights_u8": np.stack([x["weights_u8"]] * 2)}
    content = rng.random((1, 32, 32, 3), np.float32) * 200 - 100
    prev = rng.random((1, 32, 32, 3), np.float32) * 200 - 100
    wmap = np.stack(np.meshgrid(np.arange(32), np.arange(32))[::-1], -1)[None].astype(np.float32) + 1.5
    weights = rng.random((1, 32, 32, 1), np.float32)
    out = {}
    for key, mesh in (("single", None), ("tensor", _mesh(TENSOR2))):
        engine = StyleEngine(spec, params, LossConfig(), learning_rate=0.1, device="cpu", mesh=mesh)
        chain, disps = engine.optimize_frame_chain(x["prev"], aux, [x["style"]], 2, out_hw=(32, 32), blend_weights=[1.0],
                                                   init_mode="blend", use_temporal=True, temporal_blend=0.5)
        chain_log = engine.last_loss_log.numpy()
        host = engine.optimize(content, [x["style"]], prev.copy(), 2, transfer_type="vid_img",
                               temporal_warp=(prev, wmap), temporal_weights=weights)
        out[key] = (chain, disps, chain_log, host, engine.last_loss_log)
    (c0, d0, cl0, h0, hl0), (c2, d2, cl2, h2, hl2) = out["single"], out["tensor"]
    assert cl2.shape == (2, 2, 8) and cl2[:, :, -1].min() > 0 and hl2[:, -1].min() > 0
    np.testing.assert_allclose(cl2, cl0, rtol=1e-5, atol=0)
    np.testing.assert_allclose(hl2, hl0, rtol=1e-5, atol=0)
    assert float((c2 - c0).abs().mean() / c0.abs().mean()) <= 1e-2
    assert float(np.abs(h2 - h0).mean() / np.abs(h0).mean()) <= 1e-2
    assert float((d2.float() - d0.float()).abs().mean()) <= 0.5


def test_vid_img_cli_on_tensor2_matches_jax(tmp_path, monkeypatch):
    """Both whole vid_img CLIs (tests/test_torch_vid_img.py's run: 3
    frames, 16 px, 2 passes, Adam, ``--init prev_warp``, VGG-19 from the
    same npz, the same flow artifacts) with ``--gpu c --mesh tensor:2``:
    every engine on two channel shares, each of the 6 frame PNGs within
    the u8 drift bounds of JAX's (its GSPMD run on two virtual devices)
    and of the port's own unsharded run."""
    _cli_setup(tmp_path, monkeypatch)
    _write_flow_artifacts(tmp_path)
    (tmp_path / "single").mkdir()
    import shutil

    shutil.copytree(tmp_path / "torch" / "vid_style", tmp_path / "single" / "vid_style")
    shares = []
    orig = StyleEngine.__init__

    def recording(self, *a, **k):
        orig(self, *a, **k)
        shares.append(self.shares)

    monkeypatch.setattr(StyleEngine, "__init__", recording)

    def argv(out, mesh):
        a = _cli_argv(out)
        a[a.index("--mesh") + 1] = mesh
        return a

    from maua_style_tpu import style as jax_style

    jax_style.main(argv("jax", "tensor:2"))
    torch_style.main(argv("torch", "tensor:2"))
    assert shares and set(shares) == {2}
    torch_style.main(argv("single", "space:1"))
    jdir = tmp_path / "jax" / "vid_style"
    outs = sorted(glob.glob(str(jdir / "16" / "*.png")))
    assert len(outs) == 6
    for f in outs:
        _assert_u8_drift(f, f.replace("/jax/", "/torch/"))
        _assert_u8_drift(f.replace("/jax/", "/single/"), f.replace("/jax/", "/torch/"))
