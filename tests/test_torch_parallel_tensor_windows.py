"""img_vid's windows on the "tensor" mesh axis (alone, and beside "frames"
and "space"), on meshes of repeated CPU entries: the window's pieces per
(frame share, channel share, band) (``spatial.WindowLayout`` with each
row's grid, ``parallel.row_mesh``), the whole-window Gram by groups of
frame share and channel share (``ops.gram.video_gram_blocks``: K1 on each
group's diagonal block, plain products off it) against ``video_gram`` with
its rows and columns permuted into group order, the windows against JAX's
GSPMD engine on ``P(..., "tensor")`` (JAX tests/test_parallel.py:92-114's
run) and unsharded, the frozen split against the masked runner, run-state
checkpoints across layouts, and the img_vid CLI with ``--mesh tensor:2``
against JAX's.

A share's convolution sums its input channels in another order than the
whole one, so runs are held over a few iterations at JAX's bar for
"tensor" (1e-3)."""

import importlib
import os

import numpy as np
import pytest
import torch

from maua_style_tpu import style as jax_style
from maua_style_tpu.models import init_params as jax_init_params
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu.models.convert import save_npz_params
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine import optimize as optimize_module
from maua_style_tpu_torch.ops.gram import shared_video_gram, video_gram
from maua_style_tpu_torch.parallel import build_mesh, channel_shares, mesh_grid, row_mesh, sharding_for, spatial
from maua_style_tpu_torch.parallel import window_shares
from test_torch_img_vid import _u8_drift
from test_torch_parallel_tensor_video import _jax_sharding
from test_torch_parallel_windows import (_crashing, _jax_engine, _narrow, _port_engine, _small_window_inputs,
                                         _totals_apart, _window_inputs, _windowed, _write_cli_inputs)
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

jax_img_vid = importlib.import_module("maua_style_tpu.pipelines.img_vid")
torch_img_vid = importlib.import_module("maua_style_tpu_torch.pipelines.img_vid")

CPU = torch.device("cpu")
TENSOR2 = [("tensor", 2)]
FRAMES2_TENSOR2 = [("frames", 2), ("tensor", 2)]
SPACE2_TENSOR2 = [("space", 2), ("tensor", 2)]
MESHES = {"tensor2": TENSOR2, "frames2_tensor2": FRAMES2_TENSOR2}


def _mesh(axes):
    return build_mesh([CPU] * int(np.prod([s for _, s in axes])), axes)


def _layout(axes, frames, height, width, channels):
    """The engine's ``_window_layout`` of a window of ``frames`` frames of
    ``channels`` channels (bands at multiples of 8 rows)."""
    mesh = _mesh(axes)
    shares = [(row, part) for row, part in window_shares(sharding_for(mesh), frames) if part.stop > part.start]
    grids = [mesh_grid(row_mesh(mesh, row)) for row, _ in shares]
    heights = spatial.band_rows(height, len(grids[0]), 8) if len(grids[0]) > 1 else [height]
    return spatial.WindowLayout(shares, heights, channels, width, grids)


def test_window_layout_pieces_on_frames_tensor():
    """frames:2,tensor:2 (9 frames: 5 + 4) and frames:2,space:2,tensor:2:
    each row's grid is its own tensor (and space) mesh, never a row of
    bands; the pieces are (T_i, C_t, h_j, W), and a window-sized image and
    its flat L-BFGS rows go there and back bit for bit."""
    layout = _layout(FRAMES2_TENSOR2, 9, 40, 7, 3)
    assert layout.tensor == 2 and [len(g) for g in layout.grids] == [1, 1]
    x = torch.arange(9 * 3 * 40 * 7, dtype=torch.float32).reshape(9, 3, 40, 7)
    pieces = layout.split(x)
    assert [tuple(p.shape) for p in pieces] == [(5, 2, 40, 7), (5, 1, 40, 7), (4, 2, 40, 7), (4, 1, 40, 7)]
    assert torch.equal(pieces[3], x[5:, 2:])
    assert torch.equal(layout.gather(pieces, CPU), x)
    hist = torch.stack([x.flatten(), -x.flatten()])
    rows = layout.split(hist)
    assert torch.equal(rows[1], torch.stack([pieces[1].flatten(), -pieces[1].flatten()]))
    assert torch.equal(layout.gather(rows, CPU), hist)
    three = _layout([("frames", 2), *SPACE2_TENSOR2], 9, 40, 7, 3)
    assert [tuple(p.shape) for p in three.split(x)][:4] == [(5, 2, 16, 7), (5, 2, 24, 7), (5, 1, 16, 7), (5, 1, 24, 7)]
    assert torch.equal(three.gather(three.split(x), CPU), x)


@pytest.mark.parametrize("use_covariance", [False, True])
@pytest.mark.parametrize("axes, frames", [(TENSOR2, 7), (FRAMES2_TENSOR2, 9), (SPACE2_TENSOR2, 7)],
                         ids=["tensor2", "frames2_tensor2", "space2_tensor2"])
def test_group_gram_matches_permuted_video_gram(axes, frames, use_covariance):
    """The whole-window Gram of the groups (frame share i, channel share s;
    their rows t·C + c are not contiguous in the frame-major order) against
    ``video_gram`` of the whole window with rows and columns permuted into
    group order, and its gradient (a random cotangent): within 1e-6
    relative, in norm (``test_window_gram_of_shares_matches_video_gram``'s
    bar); 6 channels on 2 shares, 3 + 3."""
    c = 6
    gen = torch.Generator().manual_seed(frames + len(axes))
    x = torch.relu(torch.randn((frames, c, 24, 10), generator=gen)).requires_grad_(True)
    w = torch.randn((frames * c, frames * c), generator=gen)
    layout = _layout(axes, frames, 24, 10, c)
    order = torch.tensor([f * c + ch for _, part in layout.shares for cs in channel_shares(c, 2)
                          for f in range(part.start, part.stop) for ch in range(cs.start, cs.stop)])
    assert sorted(order.tolist()) == list(range(frames * c)) and order.tolist() != list(range(frames * c))
    want = video_gram(x, use_covariance)[order][:, order]
    (gwant,) = torch.autograd.grad(torch.sum(want * w), x)
    pieces = layout.split(x)
    groups = [col for share in layout.by_share(pieces) for col in spatial.columns(share, 2)]
    got = shared_video_gram(groups, use_covariance)
    ggot = layout.gather(torch.autograd.grad(torch.sum(got * w), pieces), CPU)
    got, want = got.detach(), want.detach()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-6
    assert float(torch.linalg.norm(ggot - gwant) / torch.linalg.norm(gwant)) <= 1e-6


@pytest.mark.parametrize("mesh", ["tensor2", "frames2_tensor2"])
def test_windows_on_tensor_match_jax_sharded(mesh, monkeypatch):
    """JAX tests/test_parallel.py:92-114 (8 frames at 16², gfw 4, Adam lr
    0.1, 3 iterations a window, video_style_factor 100) on ``mesh`` of CPU
    entries against JAX on the same axes of its virtual devices
    (P(None, None, None, "tensor"), P("frames", None, None, "tensor")) and
    against the port unsharded, within 1e-3; the loss logs within rtol
    1e-3.  Every window's pieces are (T_i, C_t, 16, 16): 2 + 1 colour
    channels of each frame share."""
    axes = MESHES[mesh]
    content, style, init = _window_inputs(16)
    want = _windowed(_jax_engine(_jax_sharding(axes)), content, style, init)
    single = _port_engine(None)
    ref = _windowed(single, content, style, init)
    seen = []
    orig = StyleEngine._window_pieces

    def recording(self, layout, pieces, *a, **k):
        seen.append([tuple(p.shape) for p in pieces])
        return orig(self, layout, pieces, *a, **k)

    monkeypatch.setattr(StyleEngine, "_window_pieces", recording)
    engine = _port_engine(_mesh(axes))
    got = _windowed(engine, content, style, init)
    rows = dict(axes).get("frames", 1)
    assert len(seen) == 3 and all(s == [(4 // rows, 2, 16, 16), (4 // rows, 1, 16, 16)] * rows for s in seen)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(engine.last_loss_log, single.last_loss_log, rtol=1e-3, atol=0)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_frozen_split_matches_masked_on_tensor2(monkeypatch, optimizer):
    """The frozen-split runner (the frozen frames' activations extracted
    once, on the row's channel shares) against the masked runner (the mask
    on every piece's device), both on tensor:2, within
    tests/test_torch_img_vid.py's 2e-4; window 1 freezes its first frame,
    window 2 its first and last two."""
    content, styles, init = _small_window_inputs(1)
    outs = []
    for split in (False, True):
        monkeypatch.setattr(optimize_module, "_WINDOW_SPLIT", split)
        engine = _narrow(_mesh(TENSOR2), optimizer)
        calls = []
        real = engine._run
        monkeypatch.setattr(engine, "_run", lambda *a, **kw: calls.append(kw.get("frozen")) or real(*a, **kw))
        outs.append(engine.optimize(content, styles, init, 3, transfer_type="img_vid", gram_frame_window=4))
        assert calls == ([None, (1, 0), (1, 2)] if split else [None] * 3)
    assert np.abs(outs[0] - init).max() > 1e-3
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)


def test_lbfgs_windows_on_frames_tensor_match_unsharded():
    """L-BFGS windows (8 frames, gfw 4, 3 iterations a window, the frozen
    split, VGG-19 narrow) on frames:2,tensor:2 against unsharded: each
    window's first two totals within rtol 1e-5 and every total within rtol
    1e-4 (the random init's first step is not float noise), mean|Δ| within
    1e-2 of mean|p| (``test_lbfgs_windows_on_a_mesh_match_unsharded``'s
    bars)."""
    content, styles, init = _small_window_inputs(0)
    kw = dict(transfer_type="img_vid", gram_frame_window=4)
    single = _narrow()
    ref = single.optimize(content, styles, init, 3, **kw)
    engine = _narrow(_mesh(FRAMES2_TENSOR2))
    got = engine.optimize(content, styles, init, 3, **kw)
    rtol = _totals_apart(engine.last_loss_log, single.last_loss_log).reshape(3, 3)
    assert rtol[:, :2].max() <= 1e-5 and rtol.max() <= 1e-4, rtol
    assert np.abs(got - ref).mean() <= 1e-2 * np.abs(ref).mean()


def test_frames_tensor_and_single_device_runs_resume_each_other(tmp_path, monkeypatch):
    """A checkpoint written mid-window on frames:2,tensor:2 (the window's
    whole pastiche and L-BFGS rows in the single-device layout) resumes on
    one device, and the other way round; either ends within 1e-4 of the
    uninterrupted one-device run."""
    content, styles, init = _small_window_inputs(3)
    kw = dict(transfer_type="img_vid", gram_frame_window=4, checkpoint_every=2)
    want = _narrow().optimize(content, styles, init, 4, run_checkpoint=str(tmp_path / "whole"), **kw)
    for first, second in ((FRAMES2_TENSOR2, None), (None, FRAMES2_TENSOR2)):
        run_dir = str(tmp_path / "rs")
        with pytest.raises(KeyboardInterrupt):
            _crashing(_narrow(first and _mesh(first)), 4, monkeypatch).optimize(content, styles, init, 4,
                                                                                run_checkpoint=run_dir, **kw)
        saved = torch.load(os.path.join(run_dir, "state.pt"), weights_only=True)
        assert saved["pastiche"]["pastiche"].shape == (4, 3, 32, 24)
        assert saved["opt_state"]["s_hist"].shape == (5, 4 * 3 * 32 * 24)
        got = _narrow(second and _mesh(second)).optimize(content, styles, init, 4, run_checkpoint=run_dir, **kw)
        assert not os.path.exists(run_dir)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_img_vid_cli_on_tensor2_matches_jax(tmp_path, monkeypatch):
    """The img_vid CLI (``test_img_vid_cli_on_a_mesh_matches_jax``'s run: 4
    frames, gfw 3,2, Adam, VGG-19 to relu3_1) with ``--gpu c --mesh
    tensor:2`` on both CLIs: every engine on two channel shares, the
    stacks within the u8 drift bounds of JAX's and the loss logs within
    rtol 1e-3 of JAX's."""
    _write_cli_inputs(tmp_path)
    npz = tmp_path / "vgg19.npz"
    save_npz_params(jax_init_params(jax_select_model("vgg19")), str(npz))

    def argv(out):
        return ["--transfer_type", "img_vid", "--content", str(tmp_path / "content.png"), "--style",
                str(tmp_path / "sv.npy"), "--output_dir", str(tmp_path / out), "--gpu", "c", "--model_file", str(npz),
                "--image_sizes", "32,48", "--num_iters", "3,2", "--num_frames", "4", "--gram_frame_window", "3,2",
                "--avg_frame_window", "4", "--optimizer", "adam", "--seed", "0", "--mesh", "tensor:2",
                "--style_layers", "relu1_1,relu2_1,relu3_1", "--content_layers", "relu3_1"]

    engines = {"jax": [], "torch": []}
    for key, module in (("jax", jax_img_vid), ("torch", torch_img_vid)):
        orig = module.build_engine
        monkeypatch.setattr(module, "build_engine", lambda args, size=None, orig=orig, key=key:
                            engines[key].append(orig(args, size)) or engines[key][-1])
    jax_style.main(argv("jax"))
    torch_style.main(argv("torch"))
    assert [e.shares for e in engines["torch"]] == [2, 2]
    for stem in ("content_sv_32", "content_sv_48", "content_sv"):
        _u8_drift(np.load(tmp_path / "torch" / f"{stem}.npy"), np.load(tmp_path / "jax" / f"{stem}.npy"))
    for je, te in zip(engines["jax"], engines["torch"]):
        np.testing.assert_allclose(te.last_loss_log, np.asarray(je.last_loss_log), rtol=1e-3, atol=1e-6)
