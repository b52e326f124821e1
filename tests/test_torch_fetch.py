"""The port's http(s) inputs and ``resize_nearest`` against the JAX
package's: one PNG served through a stand-in for ``urllib.request.urlopen``
(no network), and nearest-neighbour resizes up, down and at odd sizes."""

import io
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_style_tpu import io as jax_io
from maua_style_tpu.ops.resize import resize_nearest as jax_resize_nearest
from maua_style_tpu_torch import io as mio
from maua_style_tpu_torch.ops.resize import resize_nearest
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

URL = "https://example.com/images/style.png"


@pytest.fixture
def served(monkeypatch):
    """A 21x34 PNG's bytes, answered for ``URL`` by ``urlopen`` (both
    packages import ``urllib.request`` when they open a URL); every other
    address fails.  Returns the PNG's pixels and the addresses asked for."""
    pixels = np.random.default_rng(0).integers(0, 255, (21, 34, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    asked = []

    def urlopen(url, *a, **kw):
        asked.append(url)
        if url != URL:
            raise OSError(f"no network: {url}")
        return io.BytesIO(buf.getvalue())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return pixels, asked


def test_preprocess_reads_a_url_as_jax_does(served):
    pixels, asked = served
    want = jax_io.preprocess(URL)
    got = mio.preprocess(URL)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose((got[0] + mio.CAFFE_MEAN)[..., ::-1], pixels, atol=1e-4)
    np.testing.assert_array_equal(mio.preprocess(URL, size=(11, 17)), jax_io.preprocess(URL, size=(11, 17)))
    assert asked == [URL] * 4


def test_load_u8_reads_a_url_as_jax_does(served):
    pixels, asked = served
    got = mio.load_u8(URL)
    np.testing.assert_array_equal(got, jax_io.load_u8(URL))
    np.testing.assert_array_equal(got, pixels)
    assert got.dtype == np.uint8 and asked == [URL] * 2


def test_local_paths_are_not_fetched(served, tmp_path):
    _, asked = served
    path = tmp_path / "a.png"
    Image.fromarray(np.full((5, 7, 3), 9, np.uint8)).save(path)
    np.testing.assert_array_equal(mio.preprocess(str(path)), jax_io.preprocess(str(path)))
    with pytest.raises(OSError, match="no network"):
        mio.load_u8("http://example.com/other.png")
    assert asked == ["http://example.com/other.png"]


@pytest.mark.parametrize("hw,size", [((8, 10), (16, 20)), ((8, 10), (3, 4)), ((7, 9), (12, 5)),
                                     ((13, 11), (13, 11)), ((5, 17), (9, 3)), ((31, 29), (10, 47))])
def test_resize_nearest_matches_jax(hw, size):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), size))
    got = resize_nearest(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), size)
    assert tuple(got.shape) == (2, 3, *size)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
