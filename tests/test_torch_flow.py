"""The port's flow module (flow.py, ops/gaussian.py) on the CPU against the
JAX package's: the scipy-equivalent Gaussian blur (including a radius wider
than the frame, T1), the reliability check, the colour wheel, and the
pre-pass pair model over SPyNet + PWC with weights from one modelzoo npz
per net.  Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from maua_style_tpu import flow as jax_flow
from maua_style_tpu.models.flownets import pwc as jax_pwc
from maua_style_tpu.models.flownets import spynet as jax_spynet
from maua_style_tpu.ops import gaussian as jax_gaussian
from maua_style_tpu_torch import flow
from maua_style_tpu_torch.ops.gaussian import gaussian_blur


@pytest.mark.parametrize("mode", ["reflect", "wrap", "nearest"])
@pytest.mark.parametrize("shape,sigma", [((7, 9), 1.5), ((5, 6), 5.0), ((12, 10, 2), [5.0, 5.0, 0]), ((3, 40), [0.7, 2.0])])
def test_gaussian_blur_matches_jax_and_scipy(mode, shape, sigma):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = gaussian_blur(torch.from_numpy(x), sigma, mode=mode).numpy()
    np.testing.assert_allclose(got, scipy.ndimage.gaussian_filter(x.astype(np.float64), sigma, mode=mode), atol=1e-5)
    want = np.asarray(jax_gaussian.gaussian_blur(jnp.asarray(x), sigma, mode=mode))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _flows(seed, h=20, w=24):
    rng = np.random.default_rng(seed)
    fwd = (rng.standard_normal((h, w, 2)) * 2).astype(np.float32)
    bwd = (-fwd + rng.standard_normal((h, w, 2)) * 0.3).astype(np.float32)
    return fwd, bwd


def test_check_consistency_matches_jax():
    fwd, bwd = _flows(1)
    want = jax_flow.check_consistency(fwd, bwd)
    got = flow.check_consistency(fwd, bwd, device="cpu")
    assert got.shape == (20, 24) and got.min() >= 0 and got.max() <= 1
    # hard thresholds on float32 sums: equal decisions here, blurred values to 1e-5
    np.testing.assert_allclose(got, want, atol=1e-5)
    batched = flow._reliability(torch.from_numpy(np.stack([fwd, bwd])), torch.from_numpy(np.stack([bwd, fwd]))).numpy()
    np.testing.assert_allclose(batched[0], got, atol=1e-6)
    np.testing.assert_allclose(batched[1], jax_flow.check_consistency(bwd, fwd), atol=1e-5)


def test_flow_to_image_matches_jax():
    fwd, _ = _flows(2)
    fwd[0, 0] = np.nan
    np.testing.assert_array_equal(flow.flow_to_image(fwd), jax_flow.flow_to_image(fwd))
    np.testing.assert_array_equal(flow.make_color_wheel(), jax_flow.make_color_wheel())


def _write_modelzoo(d):
    """One npz per net in the JAX layout ({layer}/w, {layer}/b), numpy-made."""
    rng = np.random.default_rng(9)
    layouts = {
        "spynet": [e for lvl in range(jax_spynet.N_LEVELS) for e in jax_spynet._level_layout(lvl)],
        "pwc": jax_pwc._layout(),
    }
    (d / "modelzoo").mkdir()
    for name, layout in layouts.items():
        arrays = {}
        for layer, cin, cout, k in layout:
            shape = (k, k, cout, cin) if k == 4 else (k, k, cin, cout)
            arrays[f"{layer}/w"] = (rng.standard_normal(shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
            arrays[f"{layer}/b"] = (rng.standard_normal(cout) * 0.01).astype(np.float32)
        np.savez(d / "modelzoo" / f"{name}.npz", **arrays)


class _Args:
    flow_models = "spynet,pwc"
    allow_random_weights = False
    device = "cpu"


def test_pair_model_matches_jax(tmp_path, monkeypatch):
    """Both packages read the same modelzoo npz files; their net caches are
    emptied so that no other test's net leaks in (T8)."""
    _write_modelzoo(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_flow, "_MODEL_CACHE", {})
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    rng = np.random.default_rng(3)
    ims1 = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    ims2 = np.roll(ims1, 2, axis=2)

    want = jax_flow.get_flow_pair_model(_Args()).batched(ims1, ims2)
    got = flow.get_flow_pair_model(_Args()).batched(ims1, ims2)
    for g, w, shape in zip(got, want, [(2, 40, 56, 2)] * 2 + [(2, 40, 56)] * 2):
        assert g.shape == w.shape == shape
    for g, w in zip(got[:2], want[:2]):
        # max|Δ| / max|flow| <= 1e-4 (see tests/test_torch_flownets.py)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    for g, w in zip(got[2:], want[2:]):
        # reliabilities threshold the flows: a pixel whose decision flips
        # would move the blurred map by ~0.1 locally; none flips here
        np.testing.assert_allclose(g, w, atol=1e-4)

    single = flow.get_flow_pair_model(_Args())(ims1[0], ims2[0])
    np.testing.assert_allclose(single[0], got[0][0], atol=1e-5)
    est = flow.get_flow_model(_Args())(ims1[1], ims2[1])
    np.testing.assert_allclose(est, got[0][1], atol=1e-5)


def test_missing_checkpoint_raises_without_random_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="modelzoo/spynet"):
        flow.get_flow_pair_model(_Args())


def test_nets_hand_the_cost_volume_contiguous_nchw(monkeypatch):
    """The CUDA kernel refuses a channels-last view; the ensemble hands
    PWC contiguous NCHW frames, so every level's features arrive as such."""
    from maua_style_tpu_torch.models.flownets import pwc

    seen = []
    real = pwc.correlation

    def checking(f1, f2, d=4, s=1):
        seen.append(f1.is_contiguous() and f2.is_contiguous())
        return real(f1, f2, d, s)

    monkeypatch.setattr(pwc, "correlation", checking)
    net = pwc.PWCNet().eval()
    frames = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 40, 70, 3), dtype=np.uint8))
    with torch.inference_mode():
        flow._ensemble([net], frames, frames.flip(2))
    assert seen == [True] * 5
