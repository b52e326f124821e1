"""The port's StyleEngine on the CPU: chunking, printed loss lines,
snapshots, run-state checkpoints and resume, and the entry points' refusal
of transfer types that are not ported yet."""

import os

import numpy as np
import pytest
import torch

from maua_style_tpu_torch import style
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine import checkpoint
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import init_params, registry

NARROW = [8, "P", 16, "P", 16, 16, "P", 24, 24, "P", 24, "P"]


def _engine(optimizer="lbfgs", **kw):
    spec = registry._vgg_spec("vgg19", NARROW, "max")
    return StyleEngine(spec, init_params(spec, seed=1), LossConfig(), optimizer=optimizer,
                       lbfgs_history=5, device="cpu", **kw)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    content = rng.normal(0, 40, (1, 32, 32, 3)).astype(np.float32)
    style_img = rng.normal(0, 40, (1, 24, 28, 3)).astype(np.float32)
    init = rng.normal(0, 1, (1, 32, 32, 3)).astype(np.float32)
    return content, style_img, init


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_chunks_prints_and_snapshots(optimizer, capsys):
    content, style_img, init = _images()
    engine = _engine(optimizer)
    whole = engine.optimize(content, [style_img], init, 6)
    whole_log = engine.last_loss_log
    snaps = []
    chunked = _engine(optimizer).optimize(
        content, [style_img], init, 6, save_iter=4, save_callback=lambda a, i: snaps.append((a.shape, i)), print_iter=2
    )
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Iteration")]
    assert [l.split(",")[0] for l in lines] == ["Iteration 2 / 6", "Iteration 4 / 6", "Iteration 6 / 6"]
    assert snaps == [((1, 32, 32, 3), 2), ((1, 32, 32, 3), 4)]
    assert whole.shape == init.shape and whole.dtype == np.float32
    # chunk boundaries do not change the arithmetic
    np.testing.assert_array_equal(chunked, whole)
    assert whole_log.shape == (6, len(LossConfig().loss_names()))
    assert np.isfinite(whole_log).all()


def test_checkpoint_resume_matches_uninterrupted(tmp_path, monkeypatch):
    content, style_img, init = _images(1)
    want = _engine().optimize(content, [style_img], init, 6)
    run_dir = str(tmp_path / "out_32_runstate")

    engine = _engine()
    real_run, calls = engine._run, []

    def crash_on_second_chunk(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real_run(*a, **kw)

    monkeypatch.setattr(engine, "_run", crash_on_second_chunk)
    with pytest.raises(KeyboardInterrupt):
        engine.optimize(content, [style_img], init, 6, run_checkpoint=run_dir, checkpoint_every=2)
    assert os.path.exists(os.path.join(run_dir, "state.pt"))
    saved = torch.load(os.path.join(run_dir, "state.pt"), weights_only=True)
    assert saved["done_iters"] == 2 and int(saved["opt_state"]["step"]) == 2

    resumed = _engine()
    got = resumed.optimize(content, [style_img], init, 6, run_checkpoint=run_dir, checkpoint_every=2)
    np.testing.assert_array_equal(got, want)
    assert resumed.last_loss_log.shape[0] == 4  # only the iterations still to run
    assert not os.path.exists(run_dir)  # removed on completion


def test_profile_dir_writes_a_trace(tmp_path):
    content, style_img, init = _images(3)
    _engine("adam").optimize(content, [style_img], init, 3, print_iter=2, profile_dir=str(tmp_path / "prof"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_checkpoint_that_does_not_fit_is_ignored(tmp_path, capsys):
    p = torch.zeros(1, 3, 4, 4)
    checkpoint.save_state(str(tmp_path / "rs"), p, {"mu": torch.zeros(3)}, 0, 1)
    assert checkpoint.load_state(str(tmp_path / "rs"), torch.zeros(1, 3, 5, 5), {"mu": torch.zeros(3)}) is None
    assert "does not match" in capsys.readouterr().out
    assert checkpoint.load_state(str(tmp_path / "missing"), p, {}) is None


def test_bf16_compute_keeps_f32_losses():
    content, style_img, init = _images(2)
    engine = _engine(compute_dtype=torch.bfloat16)
    out = engine.optimize(content, [style_img], init, 2)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert engine.last_loss_log.dtype == np.float32


@pytest.mark.parametrize("transfer_type", ["vid_img", "img_vid"])
def test_unported_transfer_types_raise(transfer_type):
    with pytest.raises(NotImplementedError, match="Slice"):
        style.main(["--gpu", "c", "--transfer_type", transfer_type])
    content, style_img, init = _images()
    with pytest.raises(NotImplementedError, match="Slice"):
        _engine().optimize(content, [style_img], init, 1, transfer_type=transfer_type)
