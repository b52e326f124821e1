"""vid_img on "space" and "frames×space" meshes: the banded temporal term
and the banded Grams of a frame stack (f64 gradchecks), L-BFGS's per-frame
state over bands, the mesh's rows for either axis order (against JAX's
device layout), ``optimize_frame`` / ``optimize_frame_chain`` / the host
path on ``[cpu, cpu]`` against the port's unbanded runs (and their later
iterations against the unbanded run's own drift from an init one f32
spacing off), ``optimize_frames`` and the frames-stripped per-frame pass
against JAX's GSPMD engine on its virtual CPU devices (JAX
tests/test_parallel.py:185-232), a frames share on a row replica as on
distinct cards, the frame loop's auto batch on a combined mesh, and the
vid_img CLI on ``--gpu c --mesh frames:2,space:2`` (JAX :235-271's
flags) against its own unbanded run.

Bands sum Grams and convolutions in another order than the whole image
(1e-7), so one step is held tightly and a few L-BFGS iterations with
chip_smoke 6h's bars (ROADMAP "Banded against unbanded runs")."""

import glob

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.parallel import build_mesh as jax_build_mesh
from maua_style_tpu_torch import config
from maua_style_tpu_torch.engine import LBFGS, StyleEngine
from maua_style_tpu_torch.losses import LossConfig, evaluate_banded_losses, evaluate_frame_losses, evaluate_losses
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.models.convert import params_from_jax
from maua_style_tpu_torch.ops import gram as gram_ops
from maua_style_tpu_torch.ops.gram import banded_gram, batch_gram
from maua_style_tpu_torch.parallel import build_mesh, frame_shards, mesh_rows, sharding_for, spatial
from maua_style_tpu_torch.pipelines import frame_loop
from maua_style_tpu_torch.pipelines.vid_img import vid_img
from test_parallel import _engine as jax_engine
from test_torch_img_img import _assert_u8_drift
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CPU = torch.device("cpu")
SPACE2 = [("space", 2)]
FRAMES_SPACE = [("frames", 2), ("space", 2)]


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


# -- the banded Grams and the temporal term, f64 -----------------------------------


@pytest.mark.parametrize("use_covariance", [False, True])
def test_banded_gram_of_a_stack_matches_batch_gram(use_covariance, monkeypatch):
    """(B, C, h_i, W) bands -> (B, C, C): each frame's Gram (with covariance
    each frame centred on its own means) and its gradient as
    ``batch_gram`` of the whole stack, and a gradcheck.  In f64: the plain
    version's f32 cast (the Grams are f32 by design) is lifted here, so the
    bands' sums, the means and ``_GramFn``'s backward are what is held."""
    monkeypatch.setattr(gram_ops, "gram", lambda f: torch.bmm(f, f.transpose(1, 2)))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 4, 7, 5), generator=gen, dtype=torch.float64)
    heights = [3, 4]
    w = torch.randn((3, 4, 4), generator=gen, dtype=torch.float64)

    whole = x.clone().requires_grad_(True)
    want = batch_gram(whole, use_covariance)
    (gw,) = torch.autograd.grad((want * w).sum(), whole)
    bands = [b.requires_grad_(True) for b in spatial.split_rows(x, heights, [CPU, CPU], 4, 5)]
    got = banded_gram(bands, use_covariance)
    assert got.shape == (3, 4, 4)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    gb = spatial.gather_rows(torch.autograd.grad((got * w).sum(), bands), heights, CPU, 4, 5)
    torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda *bs: banded_gram(list(bs), use_covariance), tuple(bands))


def _temporal_cfg(normalize):
    return LossConfig(content_layers=(), style_layers=(), tv_weight=0.0, temporal_weight=50.0,
                      normalize_gradients=normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_banded_temporal_term_matches_unbanded(weighted, normalize):
    """``evaluate_banded_losses``' temporal term, pastiche·w against the
    warped target from per-band sums over the whole count, against
    ``evaluate_losses``' term: the value and the gradient (normalised or
    not), and a gradcheck of the unnormalised term."""
    gen = torch.Generator().manual_seed(2)
    h, w, heights = 9, 6, [4, 5]
    p = torch.randn((1, 3, h, w), generator=gen, dtype=torch.float64)
    target = torch.randn((1, 3, h, w), generator=gen, dtype=torch.float64)
    weights = torch.rand((1, 1, h, w), generator=gen, dtype=torch.float64) if weighted else None
    cfg = _temporal_cfg(normalize)
    whole = p.clone().requires_grad_(True)
    t = {"target": target, **({"weights": weights} if weighted else {})}
    want, want_per = evaluate_losses(whole, {}, {"temporal": t}, cfg)
    (gw,) = torch.autograd.grad(want, whole)

    def banded(*bs):
        tb = {"target": spatial.split_rows(target, heights, [CPU, CPU], 3, w)}
        if weighted:
            tb["weights"] = spatial.split_rows(weights, heights, [CPU, CPU], 1, w)
        return evaluate_banded_losses(list(bs), {}, {"temporal": tb}, cfg)

    bands = [b.requires_grad_(True) for b in spatial.split_rows(p, heights, [CPU, CPU], 3, w)]
    got, got_per = banded(*bands)
    torch.testing.assert_close(got_per, want_per, rtol=1e-12, atol=0)
    gb = spatial.gather_rows(torch.autograd.grad(got, bands), heights, CPU, 3, w)
    torch.testing.assert_close(gb, gw, rtol=1e-10, atol=1e-12)
    if not normalize:
        assert torch.autograd.gradcheck(lambda *bs: banded(*bs)[0], tuple(bands))


def test_banded_frame_losses_keep_frames_apart():
    """``evaluate_frame_losses`` of a banded stack: each frame's values and
    gradient as the unbanded stack's (its own content and temporal targets,
    one style target, each frame's terms normalised on their own)."""
    spec = select_model("vgg16", "max")
    cfg = LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), temporal_weight=50.0)
    engine = StyleEngine(spec, init_params(spec, seed=0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    b, h, w, heights = 3, 12, 10, [6, 6]
    x = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40)
    content = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40)
    temporal = {"target": torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(np.float32) * 40),
                "weights": torch.from_numpy(rng.random((b, 1, h, w)).astype(np.float32))}
    style = rng.random((1, 16, 16, 3), np.float32) * 100
    targets = {"style": engine.style_targets([style], [1.0]), "temporal": temporal,
               "content": {l: a for l, a in engine._extract(content, cfg.content_layers).items()}}
    whole = x.clone().requires_grad_(True)
    want, want_per = evaluate_frame_losses(whole, engine._extract(whole, cfg.all_layers), targets, cfg)
    (gw,) = torch.autograd.grad(want, whole)

    banded_engine = StyleEngine(spec, init_params(spec, seed=0), cfg, device="cpu", mesh=_mesh(SPACE2))
    split = banded_engine._band_layout(x.shape)[0]
    bands = [t.requires_grad_(True) for t in split(x)]
    btargets = {"style": targets["style"], "content": banded_engine._content_targets(content),
                "temporal": banded_engine._temporal_targets(temporal["target"], temporal["weights"])}
    got, got_per = evaluate_frame_losses(bands, banded_engine._extract_bands(bands, cfg.all_layers), btargets, cfg)
    assert got_per.shape == (b, len(cfg.loss_names()))
    np.testing.assert_allclose(got_per.detach().numpy(), want_per.detach().numpy(), rtol=1e-5, atol=0)
    gb = spatial.gather_rows(torch.autograd.grad(got, bands), heights, CPU, 3, w)
    assert float((gb - gw).abs().max() / gw.abs().max()) <= 1e-5


# -- L-BFGS: frames over bands ----------------------------------------------------------


@pytest.mark.parametrize("method", ["compact", "two_loop"])
def test_lbfgs_frames_over_bands_share_no_state(method):
    """Two frames cut into two bands each, on quadratics whose curvatures
    differ 100-fold: each frame's iterates equal its own unbanded
    single-problem run.  Inner products pooled over the frames (one step
    length, H0 or history coefficient for both) move both frames off."""
    gen = torch.Generator().manual_seed(4)
    c, h, w, heights = 3, 8, 5, [3, 5]
    curv = torch.stack([torch.rand((c, h, w), generator=gen) + 0.5, (torch.rand((c, h, w), generator=gen) + 0.5) * 100])
    x0 = torch.randn((2, c, h, w), generator=gen)
    frames_opt = LBFGS(0.5, 4, method=method, frames=True)
    bands = spatial.split_rows(x0, heights, [CPU, CPU], c, w)
    cb = spatial.split_rows(curv, heights, [CPU, CPU], c, w)
    state = frames_opt.init(bands)
    assert [tuple(v.shape) for v in state["s_hist"]] == [(2, 4, c * 3 * w), (2, 4, c * 5 * w)]
    singles = [x0[i : i + 1].clone() for i in range(2)]
    single_opt = LBFGS(0.5, 4, method=method)
    single_states = [single_opt.init(s) for s in singles]
    for _ in range(8):
        upd, state = frames_opt.update([k * b for k, b in zip(cb, bands)], state)
        bands = [b + u for b, u in zip(bands, upd)]
        for i in range(2):
            u, single_states[i] = single_opt.update(curv[i : i + 1] * singles[i], single_states[i])
            singles[i] = singles[i] + u
    got = spatial.gather_rows(bands, heights, CPU, c, w)
    for i in range(2):
        torch.testing.assert_close(got[i : i + 1], singles[i], rtol=1e-4, atol=1e-6)
    assert float(got.abs().max()) < 0.5 * float(x0.abs().max())  # it converges


# -- the mesh's rows ----------------------------------------------------------------------


@pytest.mark.parametrize("axes", [FRAMES_SPACE, [("space", 2), ("frames", 2)], [("frames", 4)],
                                  [("frames", 2), ("space", 4)]])
def test_frame_shards_rows_follow_the_row_major_layout(axes):
    """Each "frames" share is one frames index and all its "space" devices,
    in JAX's device layout for either axis order."""
    n = int(np.prod([s for _, s in axes]))
    devices = [torch.device("cuda", i) for i in range(n)]  # names only: nothing reaches CUDA
    mesh = build_mesh(devices, axes)
    jmesh = jax_build_mesh(jax.devices()[:n], axes)
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    jrows = np.moveaxis(np.vectorize(lambda d: ids[d.id])(jmesh.devices), list(jmesh.axis_names).index("frames"), 0)
    want = [tuple(devices[j] for j in row.ravel()) for row in jrows]
    assert mesh_rows(mesh) == want
    shards = frame_shards(sharding_for(mesh), 8)
    assert [row for row, _ in shards] == want
    assert [s for _, s in shards] == [slice(i * 8 // len(want), (i + 1) * 8 // len(want)) for i in range(len(want))]
    assert frame_shards(sharding_for(mesh), 8 * len(want) + 1) is None  # runs on the first row
    engine_rows = mesh_rows(mesh)[0] if mesh.size("space") > 1 else None
    spec = select_model("vgg16")
    engine = StyleEngine(spec, init_params(spec), LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1",)),
                         device="cpu", mesh=build_mesh([CPU] * n, axes))
    assert engine.band_devices == (None if engine_rows is None else [CPU] * len(engine_rows))


# -- the engine's frame paths on [cpu, cpu] against unbanded ----------------------------------


@pytest.fixture(scope="module")
def vgg19():
    spec = select_model("vgg19")
    return spec, init_params(spec, seed=0)


def _frame_inputs(h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"u8": rng.integers(0, 255, (h, w, 3)).astype(np.uint8),
            "style": rng.random((1, 32, 32, 3), np.float32) * 255 - 128,
            "prev": torch.from_numpy(rng.standard_normal((1, 3, h, w)).astype(np.float32) * 30),
            "blend": rng.integers(0, 255, (h, w, 3)).astype(np.uint8),
            "flow": rng.standard_normal((h, w, 2)).astype(np.float32) * 3,
            "weights_u8": rng.integers(0, 255, (h, w)).astype(np.uint8)}


def _totals_apart(log, ref):
    a, b = log.sum(axis=-1), ref.sum(axis=-1)
    return np.abs(a - b) / np.abs(b)


@pytest.mark.parametrize("init_mode", ["content", "random", "warp_prev", "blend"])
def test_optimize_frame_space2_matches_unbanded(vgg19, init_mode):
    """VGG-19, the default layers with the temporal term (its target the
    previous frame warped whole, reliability weights), L-BFGS history 100
    at lr 0.1, 32x32 on two bands of 16 rows, against unbanded.

    One step: every loss term within rtol 1e-5 and the step within 1e-4 of
    its max.  Five iterations: the first two totals within rtol 1e-5
    (the init's, and after the first, gradient-sized step).  From the
    0.001·N(0, 1) random init also chip_smoke 6h's bars over all five:
    every total within rtol 1e-4, mean|Δ| within 1e-2 of mean|p|.
    From an image-scale init (content, warp_prev, blend) L-BFGS's first
    curvature pair is set by float noise (its first step is lr/‖g‖₁,
    ROADMAP "Properties of the reference"), so iterations 3–5 are held by
    the test below: the banded run drifts no further than the unbanded run
    does from its own init moved one f32 spacing, or at another thread
    count."""
    spec, params = vgg19
    x = _frame_inputs()
    kw = dict(out_hw=(32, 32), blend_weights=[1.0], init_mode=init_mode, prev=x["prev"], flow=x["flow"],
              weights_u8=x["weights_u8"], use_temporal=True, blend=x["blend"], temporal_blend=0.5, seed=3)

    def run(mesh, n):
        engine = StyleEngine(spec, params, LossConfig(), learning_rate=0.1, device="cpu", mesh=mesh)
        p, disp = engine.optimize_frame(x["u8"], [x["style"]], n, **kw)
        assert p.shape == (1, 3, 32, 32) and disp.shape == (32, 32, 3) and disp.dtype == torch.uint8
        return p, engine.last_loss_log.numpy()

    p0 = run(None, 0)[0]
    (q0, l0), (q2, l2) = run(None, 1), run(_mesh(SPACE2), 1)
    assert l0[0, -1] > 0  # the temporal term is on
    np.testing.assert_allclose(l2, l0, rtol=1e-5, atol=0)
    assert float((q2 - q0).abs().max() / (q0 - p0).abs().max()) <= 1e-4

    (p0, l0), (p2, l2) = run(None, 5), run(_mesh(SPACE2), 5)
    apart = _totals_apart(l2, l0)
    assert np.isfinite(l2).all() and apart[:2].max() <= 1e-5, apart
    if init_mode == "random":
        assert apart.max() <= 1e-4, apart
        assert float((p2 - p0).abs().mean() / p0.abs().mean()) <= 1e-2


def _later_totals_apart(log, ref):
    return float(_totals_apart(log, ref)[2:].max())


def _nudged(towards):
    """``StyleEngine._run`` from its (unbanded) init moved one f32 spacing
    towards ``towards``."""
    run = StyleEngine._run

    def nudged_run(self, p0, opt, state, *a, **k):
        p0 = torch.nextafter(p0, torch.full_like(p0, towards))
        return run(self, p0, opt, opt.init(p0), *a, **k)

    return nudged_run


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("init_mode", ["content", "warp_prev", "blend"])
def test_optimize_frame_space2_drifts_no_further_than_unbanded(vgg19, init_mode, seed, monkeypatch):
    """The witness for the image-scale inits' later iterations (the test
    above): the same run as there, five iterations, on four input seeds.
    At 1 and at 4 torch threads the unbanded run is repeated from its init
    moved one f32 spacing up and one down, and the two thread counts'
    unbanded runs are held against each other.  The banded run's
    iterations 3–5 must lie no further from unbanded than twice the
    furthest of those (or 1e-4): banding is a perturbation of that size
    (1e-7 in the Grams and convolutions), not a fault.  The first two
    totals stay within rtol 1e-5 in every run.

    Run with ``-s`` to print the readings.  Iterations 3–5 of the banded
    run drift up to 5.6e-4 (content), 4.0e-4 (warp_prev) and 0.25 (blend,
    seed 3).  The unbanded run drifts up to 8.3e-4, 4.0e-4 and 1.77 from
    its nudged inits, and up to 3.4e-4, 4.0e-4 and 0.30 between the thread
    counts.  Which run lands where changes with the thread count: with
    seed 0 from warp_prev, the banded run agrees exactly at 1 thread and
    lies 4.0e-4 off at 4, and the nudged runs do the opposite."""
    spec, params = vgg19
    x = _frame_inputs(seed=seed)
    kw = dict(out_hw=(32, 32), blend_weights=[1.0], init_mode=init_mode, prev=x["prev"], flow=x["flow"],
              weights_u8=x["weights_u8"], use_temporal=True, blend=x["blend"], temporal_blend=0.5, seed=3)

    def run(mesh=None):
        engine = StyleEngine(spec, params, LossConfig(), learning_rate=0.1, device="cpu", mesh=mesh)
        engine.optimize_frame(x["u8"], [x["style"]], 5, **kw)
        return engine.last_loss_log.numpy()

    unbanded, banded, witness = {}, {}, []
    for threads in (1, 4):
        torch.set_num_threads(threads)  # the autouse fixture restores the pool
        unbanded[threads] = run()
        banded[threads] = _totals_apart(run(_mesh(SPACE2)), unbanded[threads])
        for towards in (float("inf"), float("-inf")):
            with monkeypatch.context() as m:
                m.setattr(StyleEngine, "_run", _nudged(towards))
                nudged = _totals_apart(run(), unbanded[threads])
            assert nudged[:2].max() <= 1e-5, nudged
            witness.append(float(nudged[2:].max()))
    witness.append(_later_totals_apart(unbanded[4], unbanded[1]))
    later = [float(a[2:].max()) for a in banded.values()]
    print(f"{init_mode} seed {seed}: banded {later}, nudged and threads {witness}")
    assert all(a[:2].max() <= 1e-5 for a in banded.values()), banded
    assert max(later) <= max(1e-4, 2 * max(witness)), (later, witness)


def test_optimize_frame_chain_and_host_path_space2(vgg19):
    """``optimize_frame_chain`` (two frames of a later pass: the blend init
    and the temporal target, the chained ``prev`` gathered between frames)
    and ``optimize(transfer_type="vid_img", temporal_warp=...)`` (the host
    path) on space:2 against unbanded, two L-BFGS iterations a frame (an
    image-scale init: the test above): loss logs within rtol 1e-5 (each
    frame's init and its first step); the outputs, after the first
    curvature step, within 1e-2 mean|Δ| of mean|p| (chip_smoke 6h's bar) and the
    displays within the u8 drift bound's mean 0.5."""
    spec, params = vgg19
    x = _frame_inputs()
    rng = np.random.default_rng(1)
    aux = {"content_u8": np.stack([x["u8"], x["blend"]]), "blend": np.stack([x["blend"], x["u8"]]),
           "flow": np.stack([x["flow"], x["flow"][::-1].copy()]), "weights_u8": np.stack([x["weights_u8"]] * 2)}
    content = rng.random((1, 32, 32, 3), np.float32) * 200 - 100
    prev = rng.random((1, 32, 32, 3), np.float32) * 200 - 100
    wmap = np.stack(np.meshgrid(np.arange(32), np.arange(32))[::-1], -1)[None].astype(np.float32) + 1.5
    weights = rng.random((1, 32, 32, 1), np.float32)
    out = {}
    for key, mesh in (("single", None), ("space", _mesh(SPACE2))):
        engine = StyleEngine(spec, params, LossConfig(), learning_rate=0.1, device="cpu", mesh=mesh)
        chain, disps = engine.optimize_frame_chain(x["prev"], aux, [x["style"]], 2, out_hw=(32, 32), blend_weights=[1.0],
                                                   init_mode="blend", use_temporal=True, temporal_blend=0.5)
        chain_log = engine.last_loss_log.numpy()
        host = engine.optimize(content, [x["style"]], prev.copy(), 2, transfer_type="vid_img",
                               temporal_warp=(prev, wmap), temporal_weights=weights)
        out[key] = (chain, disps, chain_log, host, engine.last_loss_log)
    (c0, d0, cl0, h0, hl0), (c2, d2, cl2, h2, hl2) = out["single"], out["space"]
    assert cl2.shape == (2, 2, 8) and cl2[:, :, -1].min() > 0 and hl2[:, -1].min() > 0  # the temporal term is on
    np.testing.assert_allclose(cl2, cl0, rtol=1e-5, atol=0)
    np.testing.assert_allclose(hl2, hl0, rtol=1e-5, atol=0)
    assert float((c2 - c0).abs().mean() / c0.abs().mean()) <= 1e-2
    assert float(np.abs(h2 - h0).mean() / np.abs(h0).mean()) <= 1e-2
    assert float((d2.float() - d0.float()).abs().mean()) <= 0.5


# -- optimize_frames and the per-frame pass against JAX's sharded engine ----------------------------


def _port_small(mesh):
    """The port's counterpart of JAX tests/test_parallel.py's ``_engine``
    (VGG-16, content relu2_2, style relu1_1 and relu2_1, Adam lr 0.1), JAX's
    weights."""
    cfg = LossConfig(content_layers=("relu2_2",), style_layers=("relu1_1", "relu2_1"), tv_weight=1e-3,
                     temporal_weight=0.0, normalize_gradients=True)
    params = params_from_jax(jax_init_params(jax_select_model("vgg16", "max"), seed=0))
    return StyleEngine(select_model("vgg16", "max"), params, cfg, optimizer="adam", learning_rate=0.1, device="cpu",
                       mesh=mesh)


def _jax_sharding(axes):
    n = int(np.prod([s for _, s in axes]))
    spec = P("frames", "space", None, None) if len(axes) == 2 else P(None, "space", None, None)
    return NamedSharding(jax_build_mesh(jax.devices()[:n], axes), spec)


def _frames_inputs():
    rng = np.random.default_rng(4)
    contents = rng.integers(0, 255, (4, 24, 24, 3)).astype(np.uint8)
    style = rng.random((1, 20, 20, 3), np.float32) * 255 - 128
    return contents, style, dict(out_hw=(20, 20), init_mode="content", blend_weights=[1.0])


def _assert_near_jax(got, want, stray=4):
    """JAX's bars (atol 1e-3, rtol 1e-4) at all but ``stray`` entries, and
    every entry within 1e-2."""
    past = np.abs(got - want) > 1e-3 + 1e-4 * np.abs(want)
    assert int(past.sum()) <= stray, (int(past.sum()), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


@pytest.mark.parametrize("axes", [SPACE2, FRAMES_SPACE], ids=["space2", "frames2_space2"])
def test_optimize_frames_matches_jax_sharded(axes, monkeypatch):
    """JAX tests/test_parallel.py:185-213's inputs: the port on ``axes`` of
    CPU entries against JAX's ``optimize_frames`` under its sharding
    (P(None, "space") on two virtual devices, P("frames", "space") on four)
    and against the port's own unbanded run; on frames:2,space:2 each row
    runs two frames on its two bands, and a batch of 3 (which the frames
    axis does not divide) runs on the first row's bands.  Against the
    port's unbanded run JAX's own bars (atol 1e-3, rtol 1e-4; displays
    within one level).  Against JAX: the loss logs within rtol 1e-4
    (2.6e-5 apart), the displays within one level, and the pastiches at
    JAX's bars but for at most 4 of their 4800 entries, every entry within
    1e-2.  From the content init the port's unbanded run already lies
    1.7e-3 from JAX's at two entries (Adam's sign(g) on float noise),
    banded or not; the batch of 3 lies within 6e-4 everywhere."""
    contents, style, kw = _frames_inputs()
    je = jax_engine(_jax_sharding(axes))
    jp, jd = je.optimize_frames(contents, [style], 5, **kw)
    jp, jd, jl = np.asarray(jp), np.asarray(jd).astype(int), np.asarray(je.last_loss_log)
    p0, d0 = _port_small(None).optimize_frames(contents, [style], 5, **kw)

    jobs = []
    orig = StyleEngine._frames_job

    def recording(self, contents_u8, *a, **k):
        jobs.append((len(contents_u8), self.band_devices))
        return orig(self, contents_u8, *a, **k)

    monkeypatch.setattr(StyleEngine, "_frames_job", recording)
    engine = _port_small(_mesh(axes))
    tp, td = engine.optimize_frames(contents, [style], 5, **kw)
    assert jobs == ([(2, [CPU, CPU])] * 2 if len(axes) == 2 else [(4, [CPU, CPU])])
    assert tp.shape == (4, 1, 3, 20, 20) and engine.last_loss_log.shape == jl.shape == (4, 5, 4)
    np.testing.assert_allclose(tp.numpy(), p0.numpy(), atol=1e-3, rtol=1e-4)
    assert np.abs(td.numpy().astype(int) - d0.numpy().astype(int)).max() <= 1
    np.testing.assert_allclose(engine.last_loss_log.numpy(), jl, rtol=1e-4, atol=0)
    _assert_near_jax(tp.numpy().transpose(0, 1, 3, 4, 2), jp)
    assert np.abs(td.numpy().astype(int) - jd).max() <= 1

    jobs.clear()
    tp3, td3 = engine.optimize_frames(contents[:3], [style], 5, **kw)
    assert jobs == [(3, [CPU, CPU])]
    np.testing.assert_allclose(tp3.numpy(), p0.numpy()[:3], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(engine.last_loss_log.numpy(), jl[:3], rtol=1e-4, atol=0)
    _assert_near_jax(tp3.numpy().transpose(0, 1, 3, 4, 2), jp[:3])
    assert np.abs(td3.numpy().astype(int) - jd[:3]).max() <= 1


def test_optimize_frames_second_row_on_a_replica(monkeypatch):
    """What ``--gpu 0,1,2,3 --mesh frames:2,space:2`` runs: the second
    row's share on a replica, a new engine on that row's "space" sub-mesh
    with the extractor's weights and the style targets copied to the row's
    first device.  On ``[cpu] * 4`` every row is the engine's own, so here
    the second row's lookup is made as on distinct cards (the engine's own
    row hidden while it builds the replica).  The replica's mesh, bands,
    weights and style cache, the share it runs, and the whole result
    against the unbanded run at JAX's bars (atol 1e-3, rtol 1e-4; loss
    logs within rtol 1e-4; displays within one level)."""
    contents, style, kw = _frames_inputs()
    single = _port_small(None)
    p0, d0 = single.optimize_frames(contents, [style], 5, **kw)
    engine = _port_small(_mesh(FRAMES_SPACE))
    replica_of = StyleEngine._replica
    shares, jobs = [], []

    def as_on_distinct_cards(self, row):
        if self is engine and len(row) > 1:  # optimize_frames' lookup of a share's row
            shares.append(row)
            if len(shares) == 2:
                own, self.band_devices = self.band_devices, None
                try:
                    return replica_of(self, row)
                finally:
                    self.band_devices = own
        return replica_of(self, row)

    frames_job = StyleEngine._frames_job

    def recording(self, contents_u8, *a, **k):
        jobs.append((self, len(contents_u8)))
        return frames_job(self, contents_u8, *a, **k)

    monkeypatch.setattr(StyleEngine, "_replica", as_on_distinct_cards)
    monkeypatch.setattr(StyleEngine, "_frames_job", recording)
    tp, td = engine.optimize_frames(contents, [style], 5, **kw)

    assert shares == [(CPU, CPU)] * 2 and list(engine._replicas) == [(CPU, CPU)]
    replica = engine._replicas[(CPU, CPU)]
    assert replica is not engine and jobs == [(engine, 2), (replica, 2)]
    assert replica.mesh.axes == (("space", 2),) and replica.band_devices == [CPU, CPU] and replica.device == CPU
    weights = engine.extractor.state_dict()
    assert all(torch.equal(v, weights[k]) for k, v in replica.extractor.state_dict().items())
    entry, cached = engine.style_cache.entry, replica.style_cache.entry
    assert cached.weights == entry.weights and all(a is b for a, b in zip(cached.styles, entry.styles))
    for layer, t in entry.targets.items():
        copy = cached.targets[layer]
        assert copy.device == replica.device and torch.equal(copy, t)
    np.testing.assert_allclose(tp.numpy(), p0.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(engine.last_loss_log.numpy(), single.last_loss_log.numpy(), rtol=1e-4, atol=0)
    assert np.abs(td.numpy().astype(int) - d0.numpy().astype(int)).max() <= 1


def test_per_frame_pass_on_frames_space_matches_jax():
    """JAX tests/test_parallel.py:215-232: a per-frame pass on
    frames:2,space:2 runs frames-stripped, here on the first row's two
    bands, against JAX's frames-stripped program (atol 1e-3, rtol 1e-4)."""
    rng = np.random.default_rng(5)
    content = rng.integers(0, 255, (24, 24, 3)).astype(np.uint8)
    style = rng.random((1, 20, 20, 3), np.float32) * 255 - 128
    kw = dict(out_hw=(20, 20), init_mode="content", blend_weights=[1.0])
    jp, _ = jax_engine(_jax_sharding(FRAMES_SPACE)).optimize_frame(content, [style], 5, **kw)
    engine = _port_small(_mesh(FRAMES_SPACE))
    assert engine.band_devices == [CPU, CPU]
    tp, _ = engine.optimize_frame(content, [style], 5, **kw)
    np.testing.assert_allclose(tp.numpy().transpose(0, 2, 3, 1), np.asarray(jp), atol=1e-3, rtol=1e-4)


# -- the frame loop and the CLI ---------------------------------------------------------------------


def test_frame_loop_auto_batch_on_a_combined_mesh(tmp_path, monkeypatch):
    """JAX frame_loop.py:382-386 on frames:2,space:2: the auto batch is
    multiplied by the "frames" axis only (space:2 alone leaves it)."""
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

    args = config.get_args(["--gpu", "c", "--content", "c.png", "--style", "s.png", "--init", "content"])
    got = {}
    for key, axes in (("frames_space", FRAMES_SPACE), ("space_frames", [("space", 2), ("frames", 2)]),
                      ("space4", [("space", 4)])):
        engine = Engine(_mesh(axes))
        frame_loop._device_first_pass_batched(args, engine, [], None, (8, 8), None, str(tmp_path / key), 8, 0,
                                              frames, 4, Saver())
        got[key] = engine.chunks
    assert got == {"frames_space": [4, 4], "space_frames": [4, 4], "space4": [2, 2, 2, 2]}


def _cli_args(tmp_path, out, mesh):
    rng = np.random.default_rng(0)
    if not (tmp_path / "vid.npy").exists():
        np.save(tmp_path / "vid.npy", rng.integers(0, 255, (4, 24, 24, 3), dtype=np.uint8))
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(tmp_path / "style.png")
    argv = ["--transfer_type", "vid_img", "--content", str(tmp_path / "vid.npy"), "--style", str(tmp_path / "style.png"),
            "--output_dir", str(tmp_path / out), "--image_sizes", "32", "--num_iters", "4", "--passes_per_scale", "2",
            "--optimizer", "lbfgs", "--learning_rate", "0.1", "--flow_models", "spynet", "--init", "random",
            "--no_hist_match", "--gpu", "c", "--scaling_args", str(tmp_path / "missing.json"), "--seed", "0",
            "--allow_random_weights"]
    return config.get_args(argv + (["--mesh", mesh] if mesh else []))


def test_vid_img_cli_on_frames_space_mesh_matches_unbanded(tmp_path, monkeypatch):
    """JAX tests/test_parallel.py:235-271's run (4 frames of 24², 2 passes
    of 2 iterations, SPyNet) with ``--gpu c --mesh frames:2,space:2`` at
    32 px (two bands of 16 rows: VGG-19's boundaries are multiples of 16):
    the stacked first pass shares its chunk out to the two rows, the
    chained second pass (blend init, temporal target) runs on the first
    row's bands; every pass's 4 frames written, each within the u8 drift
    bounds of the same run on one device.  L-BFGS as the port's CLI tests
    run it: lr 0.1, no histogram matching (it multiplies a pastiche's float
    drift by its colour gain), and ``--init random`` (the CLI's default)
    where JAX's test has ``--init content`` with Adam: from the content
    init the content term's normalised gradient is float noise, and
    L-BFGS's first curvature pair carried it to a mean of 0.72 u8 levels
    at eight torch threads."""
    monkeypatch.setattr(frame_loop, "_auto_frame_batch", lambda out_hw, requested, args=None: requested or 2)
    rows = []
    orig = StyleEngine.optimize_frames

    def recording(self, stack, *a, **k):
        rows.append((len(stack), self.mesh.axes if self.mesh else None))
        return orig(self, stack, *a, **k)

    monkeypatch.setattr(StyleEngine, "optimize_frames", recording)
    args = _cli_args(tmp_path, "mesh", "frames:2,space:2")
    assert args.mesh_shape == FRAMES_SPACE and len(args.devices) == 4
    vid_img(args)
    vid_img(_cli_args(tmp_path, "single", None))
    assert rows == [(4, tuple(FRAMES_SPACE)), (2, None), (2, None)]  # the auto chunk times "frames"
    for out in ("mesh", "single"):
        for p in (1, 2):
            assert len(glob.glob(str(tmp_path / out / "vid_style" / "32" / f"{p}_*.png"))) == 4
    for path in sorted(glob.glob(str(tmp_path / "mesh" / "vid_style" / "32" / "*.png"))):
        _assert_u8_drift(path, path.replace("/mesh/", "/single/"))
