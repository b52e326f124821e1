"""The port's similarity pipeline (``pipelines/similarity.py``) against the
JAX package's on the CPU.

Bars: histograms exactly equal (the same numpy code on the same pixels);
the distance matrix within 1e-12 (absolute) of JAX's C path and of its
numpy form, with inf where two histograms are identical; neighbours, job
plans and the sequence of img_img calls equal; the neighbour grids
pixel-equal.  One real run of the port (``--gpu c``) writes the artifact
names that JAX's naming gives its job plan."""

import importlib
import json
import os

import numpy as np
import pytest
from PIL import Image

from maua_style_tpu import config as jax_config
from maua_style_tpu.pipelines import similarity as jax_sim
from maua_style_tpu_torch import config
from maua_style_tpu_torch.pipelines import similarity as sim
from maua_style_tpu_torch.utils import name
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

jax_img_img = importlib.import_module("maua_style_tpu.pipelines.img_img")
port_img_img = importlib.import_module("maua_style_tpu_torch.pipelines.img_img")


def _mkdir(d):
    d.mkdir()
    return d


def _dataset(d, n=5, side=16, duplicate=False):
    """n images, image i a colour level near 40·i plus noise; with
    ``duplicate`` the last is a copy of the first under another name."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        base = np.full((side, side, 3), (i * 40, 200 - i * 30, (i * 70) % 256), np.uint8)
        base = base + rng.integers(0, 20, (side, side, 3), dtype=np.uint8)
        p = str(d / f"img{i}.png")
        Image.fromarray(base).save(p)
        paths.append(p)
    if duplicate:
        p = str(d / f"img{n}.png")
        Image.open(paths[0]).save(p)
        paths.append(p)
    return paths


def test_histograms_equal_and_cached(tmp_path):
    paths = _dataset(tmp_path)
    got, want = sim.compute_histograms(paths, str(tmp_path / "h.npy")), jax_sim.compute_histograms(paths)
    assert got.shape == (5, 3, 64) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "h.npy"), want)
    # the cache is read, not recomputed
    np.save(tmp_path / "h.npy", got * 2)
    np.testing.assert_array_equal(sim.compute_histograms(paths, str(tmp_path / "h.npy")), got * 2)


@pytest.mark.parametrize("native", [True, False], ids=["jax-c", "jax-numpy"])
def test_distance_matrix_matches_jax(tmp_path, monkeypatch, native):
    """Against JAX's C path (where its library loads) and its numpy form;
    the duplicated image and the diagonal get inf."""
    import maua_style_tpu.native as jax_native

    if native and jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library is not built here")
    if not native:
        monkeypatch.setattr(jax_native, "chi2_matrix_native", lambda h: None)
    hists = jax_sim.compute_histograms(_dataset(tmp_path, duplicate=True))
    got, want = sim.distance_matrix(hists, str(tmp_path / "d.npy")), jax_sim.distance_matrix(hists)
    assert got.shape == (6, 6)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(np.diag(got)).all() and np.isinf(got[0, 5]) and np.isinf(got[5, 0])
    finite = np.isfinite(want)
    assert np.abs(got[finite] - want[finite]).max() <= 1e-12
    np.testing.assert_allclose(got[0, 1], sim.chi2_distance(hists[0].ravel(), hists[1].ravel()), rtol=1e-12)
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), got)


def test_neighbours_and_grids_equal(tmp_path):
    paths = _dataset(tmp_path)
    dists = jax_sim.distance_matrix(jax_sim.compute_histograms(paths))
    got, want = sim.nearest_neighbors(paths, dists, 3), jax_sim.nearest_neighbors(paths, dists, 3)
    assert got == want and all(p not in c for p, c in zip(paths, got))
    sim.generate_grids(paths, got, str(tmp_path / "port"))
    jax_sim.generate_grids(paths, want, str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [f"img{i}.png" for i in range(5)]
    for f in os.listdir(tmp_path / "jax"):
        a, b = Image.open(tmp_path / "port" / f), Image.open(tmp_path / "jax" / f)
        assert a.size == (900, 900)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dry_run_plans_equal(tmp_path):
    _dataset(tmp_path, n=4)

    class Args:
        output_dir = str(tmp_path)

    got, want = sim.run(str(tmp_path), Args(), dry_run=True), jax_sim.run(str(tmp_path), Args(), dry_run=True)
    assert got == want and len(got) == 4 * 6  # per image: 3 pairs and C(3, 2) = 3 triples


def _recorder(calls):
    def img_img(args):
        calls.append((args.content, list(args.style), args.output, list(args.style_blend_weights), args.image_sizes))

    return img_img


def _argv(out, gpu=True):
    return ["--content", "placeholder.png", "--style", "placeholder.png", "--output_dir", out,
            "--image_sizes", "32,48", "--num_iters", "2,1"] + (["--gpu", "c"] if gpu else [])


def test_run_calls_img_img_as_jax(tmp_path, monkeypatch):
    """img_img stubbed on both sides: the same jobs, in the same order,
    with the same content, styles, output name and blend weights; and the
    grids and caches on the way."""
    paths = _dataset(_mkdir(tmp_path / "data"))
    got, want = [], []
    monkeypatch.setattr(port_img_img, "img_img", _recorder(got))
    monkeypatch.setattr(jax_img_img, "img_img", _recorder(want))
    jobs = sim.run(str(tmp_path / "data"), config.get_args(_argv(str(tmp_path / "out"))), grids=True)
    for f in ("hists.npy", "dists.npy"):  # the JAX run reads the port's caches: equal, as the tests above hold
        os.remove(tmp_path / "data" / f)
    jax_jobs = jax_sim.run(str(tmp_path / "data"), jax_config.get_args(_argv(str(tmp_path / "out"))))
    assert jobs == jax_jobs and len(got) == len(want) == 5 * 6
    assert got == want
    assert got[0][1][0] == got[0][0] == paths[0] and got[0][2] == f"{tmp_path}/out/img0_img0_{name(got[0][1][1])}"
    assert len(os.listdir(tmp_path / "data" / "grids")) == 5


def test_main_takes_a_preset_and_the_device(tmp_path, monkeypatch):
    """``--args`` reads a preset saved on a GPU host (``gpu`` "0");
    ``--gpu c`` moves it to the CPU, and without it the preset's device
    needs CUDA."""
    import torch

    _dataset(_mkdir(tmp_path / "data"), n=3)
    preset = vars(config.build_parser().parse_args(_argv(str(tmp_path / "out"), gpu=False)))
    with open(tmp_path / "preset.json", "w") as f:
        json.dump(preset, f)
    calls = []
    monkeypatch.setattr(port_img_img, "img_img", _recorder(calls))
    sim.main([str(tmp_path / "data"), "--args", str(tmp_path / "preset.json"), "--gpu", "c"])
    assert len(calls) == 3 * 3 and calls[0][4] == [32, 48]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gpu c"):
            sim.main([str(tmp_path / "data"), "--args", str(tmp_path / "preset.json")])
        with pytest.raises(RuntimeError, match="gpu c"):
            sim.main([str(tmp_path / "data")])


def test_port_run_writes_jax_names(tmp_path):
    """``main`` with ``--gpu c``: 3 images, 9 img_img jobs at 32 px, 2
    iterations each; the artifact names of JAX's plan and naming."""
    _dataset(_mkdir(tmp_path / "data"), n=3, side=40)
    sim.main([str(tmp_path / "data"), "--output_dir", str(tmp_path / "out"), "--image_sizes", "32",
              "--num_iters", "2", "--grids", "--gpu", "c"])

    class Args:
        output_dir = str(tmp_path / "out")

    plan = jax_sim.run(str(tmp_path / "data"), Args(), dry_run=True)
    want = sorted(f"{name(c)}_{'_'.join(name(s) for s in st)}_32.png" for c, st in plan)
    assert len(plan) == 9 and sorted(os.listdir(tmp_path / "out")) == want
    for f in want:
        img = np.asarray(Image.open(tmp_path / "out" / f))
        assert img.shape == (32, 32, 3) and img.std() > 0
    assert sorted(os.listdir(tmp_path / "data" / "grids")) == ["img0.png", "img1.png", "img2.png"]
    assert {"hists.npy", "dists.npy"} <= set(os.listdir(tmp_path / "data"))
