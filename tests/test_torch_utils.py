"""The port's ``utils`` (``info``, ``ssim``, ``wrapping_slice``) against
the JAX package's, and ``python -m maua_style_tpu_torch.fidelity`` against
tools/fidelity_vs_reference.py's contract (tests/test_pipeline_img.py:
168-203): SSIM 1.0 against its own output, exit code 1 under the bar."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from maua_style_tpu import utils as jax_utils
from maua_style_tpu_torch import config, fidelity, utils
from maua_style_tpu_torch.pipelines.img_img import img_img
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(24, 32, 3), (2, 24, 32, 3), (11, 11, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssim_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 41, shape), 0, 255).astype(np.uint8)
    for x, y in ((a, b), (a, a), (a, rng.integers(0, 256, shape, dtype=np.uint8))):
        assert abs(utils.ssim(x, y) - jax_utils.ssim(x, y)) <= 1e-12
    assert utils.ssim(a, a) == 1.0
    with pytest.raises(ValueError, match="shape mismatch"):
        utils.ssim(a, a[:-1])


def test_info_matches_jax(capsys):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 5.5
    for label in (None, "acts"):
        utils.info(x, label)
        jax_utils.info(x, label)
        port, jax_line = capsys.readouterr().out.splitlines()
        assert port == jax_line


@pytest.mark.parametrize("length", [1, 5, 18])
def test_wrapping_slice_matches_jax(length):
    x = np.arange(length * 2).reshape(length, 2)
    for start in range(length):
        for window in (1, 3, length, length + 2):
            got = utils.wrapping_slice(x, start, window)
            want = np.asarray(jax_utils.wrapping_slice(x, start, window))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(utils.wrapping_slice(x, start, window, return_indices=True),
                                          np.asarray(jax_utils.wrapping_slice(x, start, window, return_indices=True)))


def _write_image(path, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:48]
    img = np.stack([xx * 5 % 256, yy * 5 % 256, rng.integers(0, 256, (48, 48))], -1)
    Image.fromarray(img.astype(np.uint8)).save(path)


def test_fidelity_against_its_own_output(tmp_path, capsys):
    """The same small random-weights run twice scores SSIM 1.0 and passes;
    against another image it fails, and the module exits 1."""
    content, style = str(tmp_path / "content.png"), str(tmp_path / "style.png")
    _write_image(content, 0)
    _write_image(style, 1)

    def style_argv(out):
        return ["--content", content, "--style", style, "--output_dir", str(tmp_path / out),
                "--image_sizes", "32,48", "--num_iters", "4,3", "--optimizer", "adam", "--gpu", "c",
                "--scaling_args", str(tmp_path / "missing.json"), "--seed", "0", "--allow_random_weights"]

    np.random.seed(0)
    img_img(config.get_args(style_argv("ref")))
    ref_png = str(tmp_path / "ref" / "content_style_48.png")
    v = fidelity.main(["--reference_output", ref_png, "--"] + style_argv("ours"))
    assert v["pass"] and v["ssim"] == 1.0 and v["threshold"] == 0.98, v
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == v and set(line) == {"ssim", "threshold", "pass", "ours", "reference"}

    other = str(tmp_path / "other.png")
    Image.fromarray(np.random.default_rng(9).integers(0, 256, (48, 48, 3), dtype=np.uint8)).save(other)
    # a flat argument list works too: the tool's own flags are picked out
    v = fidelity.main(style_argv("ours2") + ["--reference_output", other, "--threshold", "0.98"])
    assert not v["pass"] and v["ssim"] < 0.98
    proc = subprocess.run([sys.executable, "-m", "maua_style_tpu_torch.fidelity", "--reference_output", other, "--",
                           *style_argv("ours3")], cwd=ROOT, capture_output=True, text=True, timeout=100)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["pass"] is False
