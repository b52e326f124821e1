"""The port's vid_img path against the JAX package's on the CPU: the
engine's frame program in its content, warp_prev and blend + temporal
modes, the chained and batched frame runners, and the whole CLI (3 frames
at 24 px, one 16 px scale, 2 passes, Adam, --init prev_warp, SPyNet + PWC
from modelzoo npz files), in two halves: the flow pre-pass, and the frame
loop on given flow artifacts.  Weights are made with numpy and handed to both
packages: the JAX nets' own init costs a minute of eager compiles on a cold
cache.  Loss logs agree within rtol 1e-3, the bound of
tests/test_torch_img_img.py; artifacts within its u8 drift bound."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_style_tpu import flow as jax_flow
from maua_style_tpu import style as jax_style
from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.io import flo as jax_flo
from maua_style_tpu.losses import LossConfig as JaxLossConfig
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.flownets import pwc as jax_pwc
from maua_style_tpu.models.flownets import spynet as jax_spynet
from maua_style_tpu.ops import frame_ops as jax_fo
from maua_style_tpu_torch import flow
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.io import flo
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import init_params, select_model
from maua_style_tpu_torch.models.convert import params_from_jax
from maua_style_tpu_torch.ops import frame_ops
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _vgg_np_params(seed=0):
    """VGG-19 weights in the JAX layout ({name: {"w": HWIO, "b"}})."""
    sd = init_params(select_model("vgg19"), seed=seed)
    names = {k.rsplit(".", 1)[0] for k in sd}
    return {n: {"w": sd[f"{n}.weight"].permute(2, 3, 1, 0).numpy().copy(), "b": sd[f"{n}.bias"].numpy().copy()} for n in names}


def _engines(cfg_kw, **engine_kw):
    params = _vgg_np_params()
    jcfg = JaxLossConfig(**cfg_kw)
    tcfg = LossConfig(**cfg_kw)
    je = JaxEngine(jax_select_model("vgg19", "max"), {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()},
                   jcfg, optimizer="adam", learning_rate=1.0, **engine_kw)
    te = StyleEngine(select_model("vgg19", "max"), params_from_jax(params), tcfg, optimizer="adam", learning_rate=1.0,
                     device="cpu", **engine_kw)
    return je, te


def _frame_inputs(seed=5, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    return {
        "u8": rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
        "blend_u8": rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
        "style": (rng.standard_normal((1, 24, 24, 3)) * 30).astype(np.float32),
        "flow": (rng.standard_normal((*hw, 2)) * 2).astype(np.float32),
        "weights_u8": rng.integers(0, 256, hw, dtype=np.uint8),
        "prev": (rng.standard_normal((1, *hw, 3)) * 40).astype(np.float32),
    }


def _compare(je, te, jax_out, torch_out):
    (jp, jd), (tp, td) = jax_out, torch_out
    want_log, got_log = np.asarray(je.last_loss_log), te.last_loss_log.numpy()
    assert got_log.shape == want_log.shape
    np.testing.assert_allclose(got_log, want_log, rtol=1e-3, atol=1e-6)
    got = tp.numpy().transpose(0, 2, 3, 1)
    assert got.shape == np.asarray(jp).shape
    np.testing.assert_allclose(got, np.asarray(jp), rtol=1e-3, atol=0.05)
    d = np.abs(td.numpy().astype(int) - np.asarray(jd).astype(int))
    assert d.max() <= 2, int(d.max())


CFG = dict(content_layers=("relu2_1",), style_layers=("relu1_1", "relu2_1"), temporal_weight=500.0)


@pytest.mark.parametrize("mode", ["content", "warp_prev"])
def test_optimize_frame_matches_jax(mode):
    x = _frame_inputs()
    je, te = _engines(CFG)
    hist = frame_ops.style_hist_stats(x["style"], rng=np.random.default_rng(0))  # fixed rng (T6)
    kw = dict(blend_weights=[1.0], init_mode=mode, hist_stats=hist)
    if mode == "content":
        kw.update(out_hw=(24, 24), content_scale=0.75)
    else:
        kw.update(out_hw=(32, 32), flow=x["flow"])
    j = je.optimize_frame(x["u8"], [x["style"]], 4, prev=None if mode == "content" else jnp.asarray(x["prev"]), **kw)
    t = te.optimize_frame(x["u8"], [x["style"]], 4, prev=None if mode == "content" else x["prev"], **kw)
    _compare(je, te, j, t)


@pytest.mark.parametrize("normalize_weights", [False, True])
def test_optimize_frame_blend_temporal_matches_jax(normalize_weights):
    """Blend init and the flow-warped, reliability-weighted temporal target;
    with --normalize_weights the strength scale leaves the temporal term
    out, as the JAX frame program's key does (T7)."""
    x = _frame_inputs(6)
    je, te = _engines(CFG, normalize_weights=normalize_weights)
    kw = dict(out_hw=(32, 32), blend_weights=[1.0], init_mode="blend", blend=x["blend_u8"], temporal_blend=0.6,
              flow=x["flow"], weights_u8=x["weights_u8"], use_temporal=True)
    j = je.optimize_frame(x["u8"], [x["style"]], 4, prev=jnp.asarray(x["prev"]), **kw)
    t = te.optimize_frame(x["u8"], [x["style"]], 4, prev=x["prev"], **kw)
    _compare(je, te, j, t)


def test_random_init_is_seeded_and_small():
    """--init random draws from torch.Generator(device).manual_seed(seed + n)
    (the JAX threefry draw cannot be reproduced, T5): repeatable, about
    0.001 * N(0, 1)."""
    x = _frame_inputs(7)
    _, te = _engines(CFG)
    outs = [te.optimize_frame(x["u8"], [x["style"]], 0, out_hw=(32, 32), init_mode="random", seed=s)[0] for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert 0.0005 < float(outs[0].std()) < 0.002


def test_chain_and_batch_runners_equal_per_frame_calls():
    rng = np.random.default_rng(8)
    contents = rng.integers(0, 256, (3, 24, 24, 3), dtype=np.uint8)
    blends = rng.integers(0, 256, (3, 24, 24, 3), dtype=np.uint8)
    flows = (rng.standard_normal((3, 24, 24, 2)) * 2).astype(np.float32)
    weights = rng.integers(0, 256, (3, 24, 24), dtype=np.uint8)
    style = (rng.standard_normal((1, 20, 20, 3)) * 30).astype(np.float32)
    _, te = _engines(CFG)
    common = dict(out_hw=(24, 24), blend_weights=[1.0])

    chain0 = torch.from_numpy((rng.standard_normal((1, 3, 16, 16)) * 30).astype(np.float32))  # a smaller scale's
    chain, disps = te.optimize_frame_chain(
        chain0, {"content_u8": contents, "blend": blends, "flow": flows, "weights_u8": weights}, [style], 3,
        init_mode="blend", use_temporal=True, temporal_blend=0.5, seeds=[0, 1, 2], **common)
    chain_log = te.last_loss_log
    prev, logs = chain0, []
    for i in range(3):
        prev, disp = te.optimize_frame(contents[i], [style], 3, init_mode="blend", prev=prev, blend=blends[i],
                                       flow=flows[i], weights_u8=weights[i], use_temporal=True, temporal_blend=0.5,
                                       seed=i, **common)
        assert torch.equal(disps[i], disp)
        logs.append(te.last_loss_log)
    assert torch.equal(chain, prev) and torch.equal(chain_log, torch.stack(logs))

    # the batch runner is one stacked step (batched convolutions take other
    # oneDNN paths than batch-1 ones): within 1e-4 of the per-frame calls
    # (measured: 8.8e-6 at |p| <= 3.0, the logs 7e-8 relative)
    outs, disps = te.optimize_frames(contents, [style], 3, init_mode="random", seeds=[5, 6, 7], **common)
    batch_log = te.last_loss_log
    assert outs.shape == (3, 1, 3, 24, 24) and batch_log.shape[:2] == (3, 3)
    for i in range(3):
        out, disp = te.optimize_frame(contents[i], [style], 3, init_mode="random", seed=5 + i, **common)
        assert float((outs[i] - out).abs().max()) <= 1e-4 and torch.equal(disps[i], disp)
        torch.testing.assert_close(batch_log[i], te.last_loss_log, rtol=1e-4, atol=0)
    with pytest.raises(ValueError):
        te.optimize_frames(contents, [style], 1, init_mode="blend", **common)


# ---------------------------------------------------------------------------
# the whole CLI


def _write_modelzoo(d):
    rng = np.random.default_rng(9)
    layouts = {
        "spynet": [e for lvl in range(jax_spynet.N_LEVELS) for e in jax_spynet._level_layout(lvl)],
        "pwc": jax_pwc._layout(),
    }
    os.makedirs(d / "modelzoo")
    for name, layout in layouts.items():
        arrays = {}
        for layer, cin, cout, k in layout:
            shape = (k, k, cout, cin) if k == 4 else (k, k, cin, cout)
            arrays[f"{layer}/w"] = (rng.standard_normal(shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
            arrays[f"{layer}/b"] = (rng.standard_normal(cout) * 0.01).astype(np.float32)
        np.savez(d / "modelzoo" / f"{name}.npz", **arrays)
    np.savez(d / "modelzoo" / "vgg19.npz",
             **{f"{n}/{k}": v for n, p in _vgg_np_params().items() for k, v in (("w", p["w"]), ("b", p["b"]))})


def _assert_u8_drift(a_path: str, b_path: str) -> None:
    """The drift bound of tests/test_torch_img_img.py: max <= 6, mean <= 0.5,
    at most 2% of pixels past 2."""
    a = np.asarray(Image.open(a_path)).astype(int)
    b = np.asarray(Image.open(b_path)).astype(int)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max() <= 6, (a_path, b_path, int(d.max()), float(d.mean()))
    assert d.mean() <= 0.5, (a_path, b_path, float(d.mean()))
    assert (d > 2).mean() <= 0.02, (a_path, b_path, int((d > 2).sum()))


def _cli_setup(tmp_path, monkeypatch):
    _write_modelzoo(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_flow, "_MODEL_CACHE", {})
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    # the frame loop draws the style statistics' jitter unseeded (T6): both
    # packages get the same fixed draw
    for mod in (jax_fo, frame_ops):
        orig = mod.style_hist_stats
        monkeypatch.setattr(mod, "style_hist_stats",
                            lambda src, mode="avg", _o=orig: _o(src, mode=mode, rng=np.random.default_rng(0)))
    rng = np.random.default_rng(0)
    np.save(tmp_path / "vid.npy", rng.integers(0, 255, (3, 24, 24, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(tmp_path / "style.png")


def _cli_argv(out):
    return [
        "--transfer_type", "vid_img", "--content", "vid.npy", "--style", "style.png",
        "--output_dir", out, "--image_sizes", "16", "--num_iters", "4", "--passes_per_scale", "2",
        "--optimizer", "adam", "--flow_models", "spynet,pwc", "--init", "prev_warp",
        "--model_file", "modelzoo/vgg19.npz", "--gpu", "c", "--mesh", "space:1",
        "--scaling_args", "missing.json", "--seed", "0",
    ]


_PAIRS = [("00001", "00002"), ("00002", "00003"), ("00003", "00001")]


def _write_flow_artifacts(d):
    """The frames and random flow artifacts of both runs ("jax", "torch"),
    so both CLIs skip the pre-pass as a resumed run does."""
    rng = np.random.default_rng(5)
    frames = np.load(d / "vid.npy")
    flows = {}
    for a, b in _PAIRS:
        flows[f"forward_{a}_{b}"] = (rng.standard_normal((24, 24, 2)) * 1.5).astype(np.float32)
        flows[f"backward_{b}_{a}"] = (rng.standard_normal((24, 24, 2)) * 1.5).astype(np.float32)
    for out in ("jax", "torch"):
        work = d / out / "vid_style"
        os.makedirs(work / "frames")
        os.makedirs(work / "flow")
        for i, f in enumerate(frames):
            Image.fromarray(f).save(work / "frames" / f"{i + 1:05d}.png")
        for stem, fl in flows.items():
            flo.write_flo(fl, str(work / "flow" / f"{stem}.flo"))
            Image.fromarray(np.random.default_rng(len(stem)).integers(0, 256, (24, 24), dtype=np.uint8)).save(
                work / "flow" / f"{stem}.png")


def test_vid_img_cli_flow_prepass_matches_jax(tmp_path, monkeypatch):
    """The CLI's first half: frame extraction and the SPyNet + PWC pre-pass
    of both packages (the pre-pass thread started and joined as the CLI
    does), compared artifact by artifact.  The CLI case below runs the
    frame loop on given flow artifacts: together the two are the whole CLI,
    split to keep each well inside the suite's per-test cap."""
    from maua_style_tpu import config as jax_config
    from maua_style_tpu.pipelines import flow_prepass as jax_prepass
    from maua_style_tpu_torch import config as torch_config
    from maua_style_tpu_torch.pipelines import flow_prepass

    _cli_setup(tmp_path, monkeypatch)
    for cfg, prepass, out in ((jax_config, jax_prepass, "jax"), (torch_config, flow_prepass, "torch")):
        frames, join = prepass.start_flow_prepass(cfg.get_args(_cli_argv(out)))
        join()
        assert [os.path.basename(f) for f in frames] == ["00001.png", "00002.png", "00003.png"]

    jdir, tdir = tmp_path / "jax" / "vid_style", tmp_path / "torch" / "vid_style"
    for f in ("00001.png", "00002.png", "00003.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tdir / "frames" / f)), np.asarray(Image.open(jdir / "frames" / f)))
    stems = [f"forward_{a}_{b}" for a, b in _PAIRS] + [f"backward_{b}_{a}" for a, b in _PAIRS]
    assert sorted(os.listdir(tdir / "flow")) == sorted(os.listdir(jdir / "flow")) == sorted(
        f"{s}.{ext}" for s in stems for ext in ("flo", "png"))
    for stem in stems:
        want, got = jax_flo.read_flo(str(jdir / "flow" / f"{stem}.flo")), flo.read_flo(str(tdir / "flow" / f"{stem}.flo"))
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), stem
        _assert_u8_drift(str(jdir / "flow" / f"{stem}.png"), str(tdir / "flow" / f"{stem}.png"))


def test_vid_img_cli_matches_jax(tmp_path, monkeypatch):
    """Both whole CLIs on the same frames and flow artifacts (written here,
    so both skip the pre-pass as a resumed run does): the prev_warp first
    pass, the blend + warped temporal second pass, the frame PNGs and the
    muxed stack."""
    _cli_setup(tmp_path, monkeypatch)
    _write_flow_artifacts(tmp_path)

    jax_style.main(_cli_argv("jax"))
    torch_style.main(_cli_argv("torch"))

    jdir, tdir = tmp_path / "jax" / "vid_style", tmp_path / "torch" / "vid_style"
    outs = sorted(os.path.relpath(p, jdir) for p in glob.glob(str(jdir / "16" / "*.png")))
    assert len(outs) == 6  # 2 passes x 3 frames
    for f in outs:
        _assert_u8_drift(str(jdir / f), str(tdir / f))
    assert np.load(tdir / "vid_style_16.npy").shape == np.load(jdir / "vid_style_16.npy").shape == (3, 16, 16, 3)


def test_vid_img_cli_needs_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the CLI would run on it")
    with pytest.raises(RuntimeError, match="--gpu c"):
        torch_style.main(["--transfer_type", "vid_img", "--content", str(tmp_path / "v.npy"), "--style", "s.png"])


def test_vid_img_host_path_matches_jax(tmp_path, monkeypatch):
    """--original_colors takes the host path (per-frame host arrays, the
    engine's ``optimize`` with a temporal warp).  SPyNet only and no
    histogram matching: this case holds the host orchestration, the CLI
    case above the flow nets."""
    _write_modelzoo(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_flow, "_MODEL_CACHE", {})
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    rng = np.random.default_rng(1)
    np.save(tmp_path / "vid.npy", rng.integers(0, 255, (3, 24, 24, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(tmp_path / "style.png")

    def argv(out):
        return [
            "--transfer_type", "vid_img", "--content", "vid.npy", "--style", "style.png",
            "--output_dir", out, "--image_sizes", "16", "--num_iters", "4", "--passes_per_scale", "2",
            "--optimizer", "adam", "--flow_models", "spynet", "--init", "prev_warp", "--original_colors",
            "--no_hist_match", "--model_file", "modelzoo/vgg19.npz", "--gpu", "c", "--mesh", "space:1",
            "--scaling_args", "missing.json", "--seed", "0",
        ]

    jax_style.main(argv("jax"))
    torch_style.main(argv("torch"))
    jdir, tdir = tmp_path / "jax" / "vid_style", tmp_path / "torch" / "vid_style"
    outs = sorted(os.path.relpath(p, jdir) for p in glob.glob(str(jdir / "16" / "*.png")))
    assert len(outs) == 6
    for f in outs:
        _assert_u8_drift(str(jdir / f), str(tdir / f))
