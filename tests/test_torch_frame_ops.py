"""The port's per-frame ops and video IO on the CPU against the JAX
package's: u8 pre/deprocess, device histogram matching, the warp map,
grid sampling, the tensor resize, .flo files and video reading.  The same
numpy inputs go to both; tensors are NCHW in the port, arrays NHWC in JAX.
Tolerances are stated per test (float32 arithmetic in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_style_tpu.io import flo as jax_flo
from maua_style_tpu.io import image as jax_image
from maua_style_tpu.io import video as jax_video
from maua_style_tpu.ops import frame_ops as jax_fo
from maua_style_tpu.ops import resize as jax_resize
from maua_style_tpu.ops import warp as jax_warp
from maua_style_tpu_torch.io import flo, image, video
from maua_style_tpu_torch.ops import frame_ops as fo
from maua_style_tpu_torch.ops import resize, warp
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kw", [{}, {"size": (20, 26)}, {"scale_factor": 0.75}, {"scale_factor": 1.37}])
def test_preprocess_deprocess_u8(kw):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    want = np.asarray(jax_fo.preprocess_u8(jnp.asarray(u8), **kw))
    got = _nhwc(fo.preprocess_u8(torch.from_numpy(u8), **kw))
    assert got.shape == want.shape
    # values to 255: float32 rounding of the interpolation weights and sums
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # the display image of the same float input: exact u8
    x = (rng.standard_normal((1, *want.shape[1:3], 3)) * 80).astype(np.float32)
    np.testing.assert_array_equal(fo.deprocess_to_u8(_nchw(x)).numpy(), np.asarray(jax_fo.deprocess_to_u8(jnp.asarray(x))))


@pytest.mark.parametrize("hw,kw", [((24, 30), {"size": (13, 17)}), ((24, 30), {"size": (48, 61)}),
                                   ((24, 30), {"scale_factor": 0.7}), ((9, 11), {"scale_factor": 2.5})])
def test_resize_bilinear_matches_jax(hw, kw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), **kw))
    got = _nhwc(resize.resize_bilinear(_nchw(x), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_style_hist_stats_and_device_match():
    rng = np.random.default_rng(2)
    style = (rng.standard_normal((1, 30, 20, 3)) * [30, 10, 50]).astype(np.float32)
    want_mu, want_qs = jax_fo.style_hist_stats(style, rng=np.random.default_rng(7))
    mu, qs = fo.style_hist_stats(style, rng=np.random.default_rng(7))  # unseeded by default (T6)
    np.testing.assert_array_equal(mu, want_mu)
    np.testing.assert_array_equal(qs, want_qs)
    x = (rng.standard_normal((1, 16, 24, 3)) @ np.array([[1, 0.5, 0], [0, 1, 0.2], [0.1, 0, 1]]) * 40).astype(np.float32)
    want = np.asarray(jax_fo.match_histogram_device(jnp.asarray(x), mu, qs))
    got = _nhwc(fo.match_histogram_device(_nchw(x), mu, qs))
    # a 3x3 eigh and two (N, 3) x (3, 3) products on values ~100
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("out_hw", [(40, 48), (20, 24), (64, 80)])
def test_warp_map_from_flow(out_hw):
    flow = (np.random.default_rng(3).standard_normal((40, 48, 2)) * 3).astype(np.float32)
    want = np.asarray(jax_fo.warp_map_from_flow(jnp.asarray(flow), out_hw))
    got = fo.warp_map_from_flow(torch.from_numpy(flow), out_hw).numpy()
    assert got.shape == want.shape == (1, *out_hw, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the host path's map (scipy's filter in the JAX package)
    np.testing.assert_allclose(flo.flow_warp_map(flow, out_hw), jax_flo.flow_warp_map(flow.copy(), out_hw), atol=2e-4)


def test_warp_map_from_flow_radius_beyond_frame():
    """sigma 5 has radius 20, more than this 6 x 7 flow: the reflections
    repeat (T1)."""
    flow = (np.random.default_rng(4).standard_normal((6, 7, 2)) * 2).astype(np.float32)
    want = np.asarray(jax_fo.warp_map_from_flow(jnp.asarray(flow), (6, 7)))
    np.testing.assert_allclose(fo.warp_map_from_flow(torch.from_numpy(flow), (6, 7)).numpy(), want, atol=1e-5)


def test_grid_sample_matches_jax_border():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, 14, 3)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 7, 9, 2)).astype(np.float32)  # some samples outside the frame
    want = np.asarray(jax_warp.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = _nhwc(warp.grid_sample(_nchw(x), torch.from_numpy(grid)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    ident = warp.identity_grid(10, 14)
    np.testing.assert_allclose(ident.numpy(), np.asarray(jax_warp.flow_to_grid(jnp.zeros((1, 10, 14, 2)), 10, 14)), atol=1e-6)


def test_flo_round_trip(tmp_path):
    flow = np.random.default_rng(6).standard_normal((7, 9, 2)).astype(np.float32)
    flo.write_flo(flow, str(tmp_path / "port.flo"))
    jax_flo.write_flo(flow, str(tmp_path / "jax.flo"))
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    np.testing.assert_array_equal(jax_flo.read_flo(str(tmp_path / "port.flo")), flow)
    np.testing.assert_array_equal(flo.read_flo(str(tmp_path / "jax.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="Magic"):
        flo.read_flo(str(tmp_path / "bad.flo"))
    rel = (np.random.default_rng(7).random((7, 9)) * 255).astype(np.uint8)
    Image.fromarray(rel).save(tmp_path / "rel.png")
    np.testing.assert_array_equal(flo.reliable_flow_weighting(str(tmp_path / "rel.png")),
                                  jax_flo.reliable_flow_weighting(str(tmp_path / "rel.png")))


def test_read_video_rgb_sources(tmp_path):
    frames = np.random.default_rng(8).integers(0, 256, (3, 10, 12, 3), dtype=np.uint8)
    np.save(tmp_path / "v.npy", frames)
    np.savez(tmp_path / "v.npz", frames=frames)
    os.makedirs(tmp_path / "dir")
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "dir" / f"{i + 1:05d}.png")
    Image.fromarray(frames[0]).save(tmp_path / "v.gif", save_all=True, append_images=[Image.fromarray(f) for f in frames[1:]])
    for src in ("v.npy", "v.npz", "dir", "v.gif"):
        want = jax_video.read_video_rgb(str(tmp_path / src))
        got = video.read_video_rgb(str(tmp_path / src))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image.load_u8(str(tmp_path / "dir" / "00002.png")),
                                  jax_image.load_u8(str(tmp_path / "dir" / "00002.png")))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        video.read_video_rgb(str(tmp_path / "empty"))
