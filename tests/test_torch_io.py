"""The port's host I/O against the JAX package's: preprocessing, PNG
artifacts, resize and histogram matching."""

import argparse
import os

import numpy as np
import pytest
from PIL import Image

from maua_style_tpu import io as jax_io
from maua_style_tpu.ops.histogram import match_histogram as jax_match_histogram
from maua_style_tpu.ops.resize import resize_bilinear_np as jax_resize
from maua_style_tpu_torch import io as mio
from maua_style_tpu_torch.ops.histogram import match_histogram
from maua_style_tpu_torch.ops.resize import resize_bilinear_np, scale_shape


def _png(path, seed, h=20, w=28):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


def test_preprocess_deprocess_identical(tmp_path):
    path = _png(tmp_path / "a.png", 0)
    got, want = mio.preprocess(path), jax_io.preprocess(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 20, 28, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(mio.preprocess(path, size=(10, 14)), jax_io.preprocess(path, size=(10, 14)))
    np.testing.assert_array_equal(np.asarray(mio.deprocess(got)), np.asarray(jax_io.deprocess(want)))


@pytest.mark.parametrize("original_colors", [False, True])
@pytest.mark.parametrize("iteration", [None, 7])
def test_save_tensor_to_file_same_bytes_and_names(tmp_path, original_colors, iteration):
    content = _png(tmp_path / "content.png", 1)
    x = np.random.default_rng(2).normal(0, 60, (1, 12, 16, 3)).astype(np.float32)
    outs = []
    for pkg, d in ((mio, "torch"), (jax_io, "jax")):
        args = argparse.Namespace(output=str(tmp_path / d / "c_s"), content=content, original_colors=original_colors)
        outs.append(pkg.save_tensor_to_file(x, args, iteration=iteration, size=32))
    got, want = outs
    assert os.path.relpath(got, tmp_path / "torch") == os.path.relpath(want, tmp_path / "jax")
    assert got.endswith(f"c_s_32{'' if iteration is None else '_7'}.png")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_process_style_images_matches_jax(tmp_path):
    (tmp_path / "dir").mkdir()
    for i in range(3):
        _png(tmp_path / "dir" / f"{i}.png", 10 + i)
    single = _png(tmp_path / "single.png", 20)
    imgs = []
    weights = []
    for pkg in (mio, jax_io):
        args = argparse.Namespace(style=[str(tmp_path / "dir"), single], style_blend_weights=[0.25, 0.75])
        imgs.append(pkg.process_style_images(args))
        weights.append(args.style_blend_weights)
    assert weights[0] == weights[1]
    assert len(imgs[0]) == len(imgs[1]) == 4
    for a, b in zip(*imgs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{"scale_factor": 0.7}, {"scale_factor": 1.9}, {"size": (9, 31)}, {"size": (40, 13)}])
def test_resize_matches_jax(kw):
    x = np.random.default_rng(3).normal(0, 50, (2, 17, 23, 3)).astype(np.float32)
    got = resize_bilinear_np(x, **kw)
    # within 1e-4: the JAX side may take its threaded C path, which sums
    # the two taps in another order
    np.testing.assert_allclose(got, jax_resize(x, **kw), atol=1e-4, rtol=0)
    if "scale_factor" in kw:
        assert got.shape[1:3] == scale_shape((17, 23), kw["scale_factor"])


@pytest.mark.parametrize("mode", [True, "avg"])
@pytest.mark.parametrize("n_sources", [1, 2])
def test_match_histogram_same_under_seed(mode, n_sources):
    rng = np.random.default_rng(4)
    target = rng.normal(0, 40, (2, 9, 11, 3)).astype(np.float32)
    sources = [rng.normal(0, 20 + 10 * i, (1, 7, 5, 3)).astype(np.float32) for i in range(n_sources)]
    src = sources if n_sources > 1 else sources[0]
    np.random.seed(11)
    got = match_histogram(target, src, mode=mode)
    after_port = np.random.randint(2**31)
    np.random.seed(11)
    want = jax_match_histogram(target, src, mode=mode)
    after_jax = np.random.randint(2**31)
    # identical numpy arithmetic, and the global RNG consumed alike
    np.testing.assert_array_equal(got, want)
    assert after_port == after_jax
    assert match_histogram(target, src, mode=False) is target
