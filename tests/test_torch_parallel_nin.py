"""NIN on "space" meshes: the band geometry of a strided convolution and of
overlapping ceil-mode pools (``parallel/spatial.py``), the asymmetric halo
exchange's gradient, NIN's banded forward against the whole image (f64),
one banded step against the unbanded one, the scaling table's NIN rows
(configs/scaling-img.json from 9088 px) building banded engines, and
``StyleEngine``'s four banded paths with NIN against its unbanded runs:
img_img, vid_img's per-frame pass, the stacked first pass on
``frames:2,space:2`` and one img_vid window.  The img_img CLI on
``--mesh space:2`` against JAX's: tests/test_torch_parallel.py.

Bars.  In f64 the bands give the whole image's features and gradient to
1e-12 (the same sums in another order).  In f32 the bands' Grams and
convolutions sum in another order than the whole image's (≈ 1e-7
relative, 5e-7 measured on the gradient), so one step is held to 1e-5
as VGG-19's is (tests/test_torch_parallel.py), and a few L-BFGS
iterations from the 0.001·N(0, 1) init to JAX tests/test_parallel.py's
atol = rtol = 1e-4: from an image-scale init L-BFGS's first curvature
pair is float noise at these sizes (ROADMAP's "Banded against unbanded
runs"), so the engine runs start from the random init."""


import numpy as np
import pytest
import torch

from maua_style_tpu_torch import config
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_losses
from maua_style_tpu_torch.models import Extractor, init_params, select_model, truncate_spec
from maua_style_tpu_torch.parallel import build_mesh, spatial
from maua_style_tpu_torch.pipelines.common import build_engine
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CPU = torch.device("cpu")
# configs/scaling-img.json's NIN layers
STYLE = ("relu1", "relu3", "relu5", "relu7", "relu9", "relu11")
CONTENT = ("relu8",)


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


def _nin(pooling="max"):
    return truncate_spec(select_model("nin", pooling), STYLE + CONTENT)


@pytest.fixture(scope="module")
def nin_params():
    return init_params(select_model("nin"), seed=0)


def _engine(params, mesh=None, **kw):
    cfg = LossConfig(content_layers=CONTENT, style_layers=STYLE)
    return StyleEngine(select_model("nin"), params, cfg, device="cpu", mesh=mesh, **kw)


# -- the geometry ----------------------------------------------------------------------


def test_nin_band_geometry():
    """Each layer's halo rows above and below (p and k − s − p), the
    alignment (the product of the strides), and VGG-19's beside it."""
    halos = {st.layer.name: (st.above, st.below) for st in spatial.band_geometry(_nin()) if st.above or st.below}
    assert halos == {"conv1": (0, 7), "pool1": (0, 1), "conv2": (2, 2), "pool2": (0, 1), "conv3": (1, 1),
                     "pool3": (0, 1), "conv4-1024": (1, 1)}
    assert spatial.band_alignment(_nin()) == 32
    assert spatial.band_alignment(truncate_spec(select_model("nin"), ("relu8",))) == 16
    assert spatial.band_alignment(truncate_spec(select_model("vgg19"), ("relu5_1",))) == 16
    vgg = {st.layer.name: (st.above, st.below) for st in spatial.band_geometry(select_model("vgg19"))}
    assert set(vgg.values()) == {(1, 1), (0, 0)}  # 3x3/1 'same' convolutions, 2x2/2 pools


@pytest.mark.parametrize("height, bands, want, even", [
    (96, 2, [32, 64], [64, 32]),  # the even cut leaves the last band no row after pool3: moved
    (160, 4, [32, 32, 32, 64], [32, 32, 64, 32]),
    (9088, 2, [4544, 4544], None),  # the scaling table's first NIN mesh row
    (11712, 4, [2944, 2912, 2912, 2944], None),
])
def test_band_rows_move_a_cut_that_empties_the_last_band(height, bands, want, even):
    spec = _nin()
    got = spatial.band_rows(height, bands, 32, spec)
    assert got == want and sum(got) == height
    assert min(spatial.level_heights(got, spec, "pool3")) >= 1
    if even is not None:
        assert spatial.band_rows(height, bands, 32) == even  # without the spec: the even cut
        assert spatial.level_heights(even, spec, "pool3")[-1] == 0


@pytest.mark.parametrize("deepest", ["relu11", "pool3"])
@pytest.mark.parametrize("height, bands", [(64, 2), (128, 4)])
def test_band_rows_refuse_where_no_cut_keeps_a_row(height, bands, deepest):
    """64 rows on 2 bands: 32 + 32 leaves the last band 0 rows after pool3
    (up to relu11 conv4-1024 would also read a halo row from it), and no
    other multiple of 32 makes two bands."""
    spec = truncate_spec(select_model("nin"), (deepest,))
    with pytest.raises(ValueError, match=f"^{height} rows do not make {bands} bands.*nin"):
        spatial.band_rows(height, bands, 32, spec)


@pytest.mark.parametrize("rows", [(0, 7), (2, 2), (0, 1), (1, 3)])
@pytest.mark.parametrize("neighbours", ["both", "above", "below"])
def test_asymmetric_halo_pad_gradcheck(neighbours, rows):
    """``halo_pad`` with ``top`` rows of the band above and ``bottom`` of the
    band below (zeros at an edge): the rows it stacks, and a gradcheck of
    the backward that sends each halo's gradient to its neighbour."""
    top, bottom = rows
    gen = torch.Generator().manual_seed(top * 10 + bottom)

    def rnd(h):
        return torch.randn((1, 2, h, 4), generator=gen, dtype=torch.float64, requires_grad=True)

    x, above, below = rnd(3), rnd(8), rnd(7)
    above = above if neighbours in ("both", "above") else None
    below = below if neighbours in ("both", "below") else None
    out = spatial.halo_pad(x, above, below, top, bottom)
    assert out.shape == (1, 2, top + 3 + bottom, 4)
    assert torch.equal(out[:, :, top : top + 3], x)
    if above is None:
        assert torch.all(out[:, :, :top] == 0)
    else:
        assert torch.equal(out[:, :, :top], above[:, :, 8 - top :])
    if below is None:
        assert torch.all(out[:, :, top + 3 :] == 0)
    else:
        assert torch.equal(out[:, :, top + 3 :], below[:, :, :bottom])
    inputs = tuple(t for t in (x, above, below) if t is not None)

    def fn(*ts):
        it = iter(ts)
        return spatial.halo_pad(next(it), next(it) if above is not None else None,
                                next(it) if below is not None else None, top, bottom)

    assert torch.autograd.gradcheck(fn, inputs)


# -- NIN's forward and one step ----------------------------------------------------------


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("height, bands, width", [(96, 2, 40), (160, 4, 45), (224, 3, 64), (300, 2, 37)])
def test_nin_banded_forward_matches_whole(pooling, height, bands, width):
    """Every layer up to relu11 (pool1 and pool3 too) on bands against the
    whole image, and the gradient of a random projection of them, in f64:
    within 1e-12 (ragged last bands, a moved cut at 96 and 160 rows, widths
    whose ceil-mode pools add a trailing window)."""
    layers = ("relu1", "relu3", "pool1", "relu5", "relu7", "relu8", "relu9", "pool3", "relu11")
    spec = truncate_spec(select_model("nin", pooling), layers)
    net = Extractor(spec, init_params(spec, seed=1)).double()
    gen = torch.Generator().manual_seed(height)
    x = torch.randn((1, 3, height, width), generator=gen, dtype=torch.float64)
    heights = spatial.band_rows(height, bands, spatial.band_alignment(spec), spec)
    whole_x = x.clone().requires_grad_(True)
    whole = net(whole_x, layers)
    bands_x = [b.requires_grad_(True) for b in spatial.split_rows(x, heights, [CPU] * bands, 3, width)]
    banded = spatial.banded_forward([net] * bands, bands_x, layers)
    proj = {l: torch.randn(whole[l].shape, generator=gen, dtype=torch.float64) for l in layers}
    for l in layers:
        assert [a.shape[2] for a in banded[l]] == spatial.level_heights(heights, spec, l), l
        torch.testing.assert_close(torch.cat(banded[l], dim=2), whole[l], rtol=1e-12, atol=1e-12)
    (want,) = torch.autograd.grad(sum((whole[l] * proj[l]).sum() for l in layers), whole_x)
    got = torch.autograd.grad(sum((torch.cat(banded[l], dim=2) * proj[l]).sum() for l in layers), bands_x)
    torch.testing.assert_close(spatial.gather_rows(got, heights, CPU, 3, width), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bands, height", [(2, 96), (2, 128), (4, 160), (4, 256)])
def test_nin_banded_step_matches_unbanded(nin_params, bands, height):
    """One step's loss terms and gradient, NIN with the scaling table's
    layers, on ``bands`` CPU entries against the unbanded step, f32: the
    terms within 1e-5 relative, the gradient within 1e-5 of its max."""
    one, two = _engine(nin_params), _engine(nin_params, _mesh([("space", bands)]))
    assert two.band_align == 32
    rng = np.random.default_rng(height + bands)
    width = 48
    content = rng.random((1, height, width, 3), np.float32) * 255 - 128
    style = rng.random((1, 96, 96, 3), np.float32) * 255 - 128
    cfg = one.loss_cfg
    style_t = one.style_targets([style], [1.0])
    x = torch.from_numpy(rng.standard_normal((1, 3, height, width)).astype(np.float32) * 50)
    whole = x.clone().requires_grad_(True)
    total, per = evaluate_losses(whole, one._extract(whole, cfg.all_layers),
                                 {"content": one.content_targets(content), "style": style_t}, cfg)
    (grad,) = torch.autograd.grad(total, whole)
    split, gather = two._band_layout(x.shape)
    bands_x = [b.requires_grad_(True) for b in split(x)]
    btotal, bper = evaluate_banded_losses(bands_x, two._extract_bands(bands_x, cfg.all_layers),
                                          {"content": two.content_targets(content), "style": style_t}, cfg)
    bgrad = gather(list(torch.autograd.grad(btotal, bands_x)))
    per, bper = per.detach(), bper.detach()
    assert float(((bper - per).abs() / per.abs().clamp(min=1e-30)).max()) <= 1e-5
    assert float((bgrad - grad).abs().max() / grad.abs().max()) <= 1e-5


@pytest.mark.parametrize("size, mesh", [(9088, "space:2"), (11712, "space:4"), (15424, "space:8")])
def test_scaling_preset_nin_rows_build_banded_engines(size, mesh):
    """configs/scaling-img.json's NIN rows on the port's CLI settings
    (``--gpu c --mesh ...``, the table's default path): NIN with the
    table's layers and Adam, on every band of the mesh, the image's rows
    cut at multiples of 32 with a row for each band at every layer."""
    args = config.get_args(["--gpu", "c", "--mesh", mesh, "--content", "c.png", "--style", "s.png",
                            "--allow_random_weights"])
    engine = build_engine(args, size)
    n = int(mesh.split(":")[1])
    assert engine.spec.arch == "nin" and engine.optimizer_name == "adam"
    assert engine.loss_cfg.style_layers == STYLE and engine.loss_cfg.content_layers == CONTENT
    assert engine.band_devices == [CPU] * n and engine.band_align == 32
    heights = spatial.band_rows(size, n, engine.band_align, engine.spec)
    assert sum(heights) == size and min(spatial.level_heights(heights, engine.spec, "relu11")) >= 1


# -- the engine's banded paths against unbanded ---------------------------------------------


def _assert_runs_agree(got, want, got_log, want_log):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_log), np.asarray(want_log), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("axes", [[("space", 2)], [("space", 4)]])
def test_img_img_on_space_matches_unbanded(nin_params, axes):
    """``optimize`` at 160x48 (4 bands: a moved cut), 5 L-BFGS iterations
    from the 0.001·N(0, 1) init: the pastiche and the loss log within 1e-4."""
    rng = np.random.default_rng(1)
    content = rng.random((1, 160, 48, 3), np.float32) * 255 - 128
    style = rng.random((1, 96, 96, 3), np.float32) * 255 - 128
    init = rng.standard_normal((1, 160, 48, 3)).astype(np.float32) * 0.001
    one, two = _engine(nin_params), _engine(nin_params, _mesh(axes))
    want = one.optimize(content, [style], init.copy(), 5, blend_weights=[1.0])
    got = two.optimize(content, [style], init.copy(), 5, blend_weights=[1.0])
    _assert_runs_agree(got, want, two.last_loss_log, one.last_loss_log)


def test_vid_img_frame_on_space_matches_unbanded(nin_params):
    """vid_img's per-frame pass (``optimize_frame``, random init, the
    temporal term from a flow-warped previous frame) on space:2 against
    unbanded: the pastiche and the loss log within 1e-4."""
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 255, (100, 52, 3)).astype(np.uint8)
    style = rng.random((1, 96, 96, 3), np.float32) * 255 - 128
    prev = rng.standard_normal((1, 96, 48, 3)).astype(np.float32) * 30
    flow = rng.standard_normal((100, 52, 2)).astype(np.float32)
    kw = dict(out_hw=(96, 48), init_mode="random", blend_weights=[1.0], prev=prev, flow=flow, use_temporal=True,
              seed=3)
    results = []
    for mesh in (None, _mesh([("space", 2)])):
        engine = _engine(nin_params, mesh)
        engine.loss_cfg = LossConfig(content_layers=CONTENT, style_layers=STYLE, temporal_weight=50.0)
        p, _ = engine.optimize_frame(frame, [style], 5, **kw)
        results.append((p.numpy(), engine.last_loss_log.numpy()))
    (want, want_log), (got, got_log) = results
    assert want_log[0, -1] > 0  # the temporal term is on
    _assert_runs_agree(got, want, got_log, want_log)


def test_stacked_first_pass_on_frames_space_matches_unbanded(nin_params):
    """vid_img's stacked first pass (``optimize_frames``, random init) on
    frames:2,space:2, two rows of two bands, against unbanded: each frame's
    pastiche and loss log within 1e-4."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 255, (4, 96, 44, 3)).astype(np.uint8)
    style = rng.random((1, 96, 96, 3), np.float32) * 255 - 128
    kw = dict(out_hw=(96, 44), init_mode="random", blend_weights=[1.0])
    one, four = _engine(nin_params), _engine(nin_params, _mesh([("frames", 2), ("space", 2)]))
    want, _ = one.optimize_frames(frames, [style], 4, **kw)
    got, _ = four.optimize_frames(frames, [style], 4, **kw)
    assert four.last_loss_log.shape == (4, 4, len(one.loss_cfg.loss_names()))
    _assert_runs_agree(got.numpy(), want.numpy(), four.last_loss_log.numpy(), one.last_loss_log.numpy())


def test_img_vid_window_on_space_matches_unbanded(nin_params):
    """One img_vid window (3 frames, gfw 3, the dynamic term on) on space:2
    against unbanded, 4 L-BFGS iterations from the random init: the window
    and the loss log within 1e-4."""
    rng = np.random.default_rng(5)
    content = rng.random((1, 96, 40, 3), np.float32) * 255 - 128
    style = rng.random((3, 96, 40, 3), np.float32) * 255 - 128
    init = rng.standard_normal((3, 96, 40, 3)).astype(np.float32) * 0.001
    cfg = LossConfig(content_layers=CONTENT, style_layers=STYLE, video_style_factor=100.0)
    runs = []
    for mesh in (None, _mesh([("space", 2)])):
        engine = StyleEngine(select_model("nin"), nin_params, cfg, device="cpu", mesh=mesh)
        out = engine.optimize(content, [style], init.copy(), 4, transfer_type="img_vid", gram_frame_window=3)
        runs.append((out, engine.last_loss_log))
    (want, want_log), (got, got_log) = runs
    _assert_runs_agree(got, want, got_log, want_log)
