"""The port's ``--fuse_scales`` (``StyleEngine.optimize_pyramid`` through
``pipelines/img_img._fused_pyramid``) against the JAX package's, on one
CPU device and on ``space:2`` and ``tensor:2`` meshes; against the port's
own per-scale loop; its fallbacks to the loop, its resume, and a second
pyramid on one engine.

Both packages draw the colour statistics of the fused path
(``style_hist_stats``) from an unseeded generator; the tests hand both one
seeded draw.  The content is a 60x40 portrait, so that its 32 and 48 px
scales (32x21, 48x32) cut into two bands of VGG-19's 16-row multiples."""

import importlib
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from maua_style_tpu import style as jax_style
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu_torch import config
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.parallel import Mesh
from test_torch_img_img import _assert_u8_drift, _recording
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

jax_frame_ops = importlib.import_module("maua_style_tpu.ops.frame_ops")
jax_img_img = importlib.import_module("maua_style_tpu.pipelines.img_img")
torch_img_img = importlib.import_module("maua_style_tpu_torch.pipelines.img_img")

SIZES = (32, 48)
ITERS = (4, 3)
NAME = "content_style"


def _write_inputs(d):
    """tests/test_torch_img_img.py's 40x60 content, transposed, and a 40x60
    style."""
    yy, xx = np.mgrid[0:40, 0:60]
    content = np.stack([xx * 4 % 256, yy * 6 % 256, ((xx - 30) ** 2 + (yy - 20) ** 2 < 200) * 255], -1)
    Image.fromarray(content.transpose(1, 0, 2).astype(np.uint8)).save(d / "content.png")
    s = (np.sin(yy / 3) * 127 + 128).astype(np.uint8)
    Image.fromarray(np.stack([s, 255 - s, np.roll(s, 8, 0)], -1)).save(d / "style.png")


def _argv(d, out, *extra, optimizer="adam", mesh="space:1", style="style.png"):
    return ["--content", str(d / "content.png"), "--style", *(str(d / s) for s in style.split(",")),
            "--output_dir", str(d / out), "--gpu", "c", "--model_file", str(d / "vgg19.npz"),
            "--image_sizes", ",".join(map(str, SIZES)), "--num_iters", ",".join(map(str, ITERS)), "--seed", "0",
            "--optimizer", optimizer, "--scaling_args", str(d / "none.json"), "--mesh", mesh, *extra]


@pytest.fixture
def inputs(tmp_path):
    _write_inputs(tmp_path)
    save_npz_params(jax_init_params(jax_select_model("vgg19")), str(tmp_path / "vgg19.npz"))
    return tmp_path


@pytest.fixture
def replayed_hist_stats(monkeypatch):
    """One seeded draw of the colour statistics in both packages (JAX's
    ``_fused_pyramid`` imports ``style_hist_stats`` when it runs)."""
    for module, orig in ((jax_frame_ops, jax_frame_ops.style_hist_stats),
                         (torch_img_img, torch_img_img.style_hist_stats)):
        monkeypatch.setattr(module, "style_hist_stats",
                            lambda source, mode="avg", _orig=orig: _orig(source, mode=mode, rng=np.random.default_rng(5)))


def _run(argv) -> np.ndarray:
    """The port's img_img on ``argv``'s settings, seeded as the CLI seeds
    it; its return value."""
    args = config.get_args(argv)
    np.random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    return torch_img_img.img_img(args)


# Adam with histogram matching on: the device recolouring between scales is
# what sets the fused path apart from the loop.  L-BFGS without it, as
# tests/test_torch_img_img.py says why.
CASES = {"adam": (), "lbfgs": ("--no_hist_match",)}


@pytest.mark.parametrize("mesh", ["space:1", "space:2", "tensor:2"])
@pytest.mark.parametrize("optimizer", sorted(CASES))
def test_fuse_scales_matches_jax(inputs, monkeypatch, capsys, replayed_hist_stats, optimizer, mesh):
    """``--fuse_scales`` on both CLIs, on the same mesh: every scale's PNG
    within tests/test_torch_img_img.py's u8 drift bounds, the one engine's
    loss log (both scales' iterations) within rtol 1e-3."""
    jax_engines, torch_engines = [], []
    _recording(monkeypatch, jax_img_img, jax_engines)
    _recording(monkeypatch, torch_img_img, torch_engines)
    extra = ("--fuse_scales", *CASES[optimizer])
    jax_style.main(_argv(inputs, "jax", *extra, optimizer=optimizer, mesh=mesh))
    torch_style.main(_argv(inputs, "torch", *extra, optimizer=optimizer, mesh=mesh))

    out = capsys.readouterr().out
    assert out.count("Fused pyramid: 2 scale(s) [32, 48] in one program") == 2 and "unavailable" not in out
    assert len(jax_engines) == len(torch_engines) == 1
    engine = torch_engines[0]
    assert (engine.band_devices is not None, engine.shares) == {"space:1": (False, 1), "space:2": (True, 1),
                                                               "tensor:2": (False, 2)}[mesh]
    for size in SIZES:
        name = f"{NAME}_{size}.png"
        _assert_u8_drift(str(inputs / "jax" / name), str(inputs / "torch" / name))
    assert engine.last_loss_log.shape == (sum(ITERS), 8)
    np.testing.assert_allclose(engine.last_loss_log, np.asarray(jax_engines[0].last_loss_log), rtol=1e-3, atol=1e-6)


# JAX's test runs Adam from the content init; L-BFGS runs from the random
# init, since from an image-scale init its first curvature pair is float
# noise (ROADMAP "Properties of the reference")
@pytest.mark.parametrize("optimizer,init", [("adam", "content"), ("lbfgs", "random")])
def test_fuse_scales_matches_the_loop_without_matching(inputs, capsys, optimizer, init):
    """Without histogram matching the fused path is the per-scale loop
    with the init resized on the device: JAX's
    ``test_fuse_scales_matches_per_scale_loop`` bars (atol 0.5, rtol 1e-4
    on the result), and each scale's artifact within the u8 drift bounds."""
    outs = {}
    for key, extra in (("loop", ()), ("fused", ("--fuse_scales",))):
        outs[key] = _run(_argv(inputs, key, "--init", init, "--no_hist_match", *extra, optimizer=optimizer))
    assert "Fused pyramid: 2 scale(s) [32, 48] in one program" in capsys.readouterr().out
    assert outs["fused"].shape == outs["loop"].shape == (1, 48, 32, 3)
    np.testing.assert_allclose(outs["fused"], outs["loop"], atol=0.5, rtol=1e-4)
    for size in SIZES:
        name = f"{NAME}_{size}.png"
        _assert_u8_drift(str(inputs / "loop" / name), str(inputs / "fused" / name))


def _table_swaps_learning_rate(d):
    with open(d / "table.json", "w") as f:
        json.dump({"32": {"learning_rate": 1.0}, "48": {"learning_rate": 0.5}}, f)
    return ("--scaling_args", str(d / "table.json"))


def _array_setting(monkeypatch):
    """A setting whose ``==`` is elementwise (an array): the comparison
    cannot decide, so the fused path falls back (JAX's dict comparison
    raises)."""
    orig = torch_img_img.set_model_args

    def set_model_args(args, size):
        orig(args, size)
        args.table_values = np.ones(2)

    monkeypatch.setattr(torch_img_img, "set_model_args", set_model_args)


# per fallback: extra flags (a function of the input directory), the styles,
# a patch, and the reason printed
FALLBACKS = {
    "save_iter": (lambda d: ("--save_iter", "2"), "style.png", None, "--save_iter writes per-iteration snapshots"),
    "checkpoint_every": (lambda d: ("--checkpoint_every", "2"), "style.png", None,
                         "--checkpoint_every needs per-chunk run-state saves"),
    "profile_dir": (lambda d: ("--profile_dir", str(d / "trace")), "style.png", None,
                    "--profile_dir traces one chunk at a time"),
    "two_styles": (lambda d: (), "style.png,style2.png", None, "multi-style histogram matching is host-only"),
    "scaling_table": (_table_swaps_learning_rate, "style.png", None,
                      "the scaling table swaps settings across these scales"),
    "array_setting": (lambda d: (), "style.png", _array_setting,
                      "the scaling table swaps settings across these scales"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fuse_scales_falls_back_to_the_loop(inputs, monkeypatch, capsys, case):
    """Each request the fused path cannot serve prints JAX's warning and
    runs the per-scale loop: the result equals the loop's own."""
    flags, style, patch, reason = FALLBACKS[case]
    Image.open(inputs / "style.png").transpose(Image.Transpose.FLIP_LEFT_RIGHT).save(inputs / "style2.png")
    if patch is not None:
        patch(monkeypatch)
    extra = flags(inputs)
    loop = _run(_argv(inputs, "loop", *extra, style=style))
    capsys.readouterr()
    fused = _run(_argv(inputs, "fused", *extra, "--fuse_scales", style=style))
    out = capsys.readouterr().out
    assert f"Warning: --fuse_scales unavailable ({reason}); using the per-scale loop." in out
    assert "Fused pyramid" not in out
    np.testing.assert_array_equal(fused, loop)


def test_fuse_scales_resumes_a_leading_prefix(inputs, monkeypatch, capsys):
    """With the first scale's artifact present the fused path reads it and
    runs the rest, as the loop resumes: the 32 px artifact untouched, one
    engine over [48], and the result within the u8 drift bounds of the
    loop's resume from the same artifact (without matching).  With every
    artifact present it builds no engine."""
    engines = []
    _recording(monkeypatch, torch_img_img, engines)
    first = _argv(inputs, "fused", "--no_hist_match", "--fuse_scales")
    _run(first)
    os.remove(inputs / "fused" / f"{NAME}_48.png")
    os.makedirs(inputs / "loop")
    Image.open(inputs / "fused" / f"{NAME}_32.png").save(inputs / "loop" / f"{NAME}_32.png")
    stamp = os.path.getmtime(inputs / "fused" / f"{NAME}_32.png")
    capsys.readouterr()
    _run(first)
    assert "Fused pyramid: 1 scale(s) [48] in one program" in capsys.readouterr().out
    assert len(engines) == 2 and engines[1].last_loss_log.shape == (ITERS[1], 8)
    assert os.path.getmtime(inputs / "fused" / f"{NAME}_32.png") == stamp
    _run(_argv(inputs, "loop", "--no_hist_match"))
    assert len(engines) == 3
    _assert_u8_drift(str(inputs / "loop" / f"{NAME}_48.png"), str(inputs / "fused" / f"{NAME}_48.png"))

    out = _run(first)
    assert len(engines) == 3
    np.testing.assert_array_equal(out, torch_img_img.mio.preprocess(str(inputs / "fused" / f"{NAME}_48.png")))


def test_fuse_scales_falls_back_on_a_gap(inputs, monkeypatch, capsys):
    """A later scale's artifact behind a missing earlier one: the port
    falls back to the loop, which runs the missing scale and resumes from
    the later artifact (JAX's fused path recomputes and overwrites it)."""
    engines = []
    _recording(monkeypatch, torch_img_img, engines)
    os.makedirs(inputs / "fused")
    later = inputs / "fused" / f"{NAME}_48.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (48, 32, 3), dtype=np.uint8)).save(later)
    stamp, pixels = os.path.getmtime(later), np.asarray(Image.open(later))
    out = _run(_argv(inputs, "fused", "--fuse_scales"))
    assert ("Warning: --fuse_scales unavailable (a later scale's artifact exists behind a missing one); "
            "using the per-scale loop.") in capsys.readouterr().out
    assert len(engines) == 1 and os.path.exists(inputs / "fused" / f"{NAME}_32.png")
    assert os.path.getmtime(later) == stamp
    np.testing.assert_array_equal(np.asarray(Image.open(later)), pixels)
    np.testing.assert_array_equal(out, torch_img_img.mio.preprocess(str(later)))


@pytest.fixture(scope="module")
def small_vgg():
    spec = select_model("vgg19")
    return spec, init_params(spec, seed=0)


def test_second_pyramid_on_one_engine_scales_its_own_targets(small_vgg, monkeypatch):
    """A second ``optimize_pyramid`` on the same engine with other content
    and style sizes and ``normalize_weights``: its strength scales (from
    its own targets) equal a fresh engine's and differ from the first
    call's, and so do its outputs and loss log (JAX's runner is cached
    without the shapes and keeps the first call's scales)."""
    spec, params = small_vgg
    rng = np.random.default_rng(4)
    # relu1_1's 64 channels: the content scale is 1 / max(64, h, w)
    cfg = LossConfig(content_layers=("relu1_1",), style_layers=("relu1_1", "relu3_1", "relu5_1"))

    def pyramid(hws, style_sides):
        contents = [rng.normal(0, 40, (1, h, w, 3)).astype(np.float32) for h, w in hws]
        styles = [[rng.normal(0, 40, (1, s, s, 3)).astype(np.float32)] for s in style_sides]
        init = rng.normal(0, 1, (1, *hws[0], 3)).astype(np.float32)
        return contents, styles, init, [(hw, 2) for hw in hws]

    first, second = pyramid([(32, 32), (48, 40)], [40, 56]), pyramid([(72, 64), (96, 80)], [32, 72])
    scales = []
    orig = StyleEngine._strength_scale
    monkeypatch.setattr(StyleEngine, "_strength_scale", lambda self, t: scales.append(orig(self, t)) or scales[-1])

    def engine():
        return StyleEngine(spec, params, cfg, optimizer="adam", normalize_weights=True, device="cpu")

    shared = engine()
    shared.optimize_pyramid(*first)
    again = shared.optimize_pyramid(*second)
    again_log = shared.last_loss_log
    fresh = engine()
    want = fresh.optimize_pyramid(*second)
    assert len(scales) == 6
    assert scales[2:4] == scales[4:6] and scales[2:4] != scales[0:2]
    for a, b in zip(again, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again_log, fresh.last_loss_log)
    assert again_log.shape == (4, len(cfg.loss_names()))


def test_pyramid_scale_a_mesh_cannot_cut_raises(small_vgg):
    """On space:2 VGG-19 to relu5_1 needs bands of 16-row multiples: a
    24-row scale cannot be cut, and the error names the scale."""
    spec, params = small_vgg
    engine = StyleEngine(spec, params, LossConfig(), optimizer="adam", device="cpu",
                         mesh=Mesh(devices=(torch.device("cpu"),) * 2, axes=(("space", 2),)))
    rng = np.random.default_rng(5)
    contents = [rng.normal(0, 40, (1, 24, 32, 3)).astype(np.float32)]
    with pytest.raises(ValueError, match=r"scale 0 \(24x32\)"):
        engine.optimize_pyramid(contents, [[contents[0]]], contents[0], [((24, 32), 1)])
