"""Small shared helpers (JAX counterpart: maua_style_tpu/utils)."""

from __future__ import annotations

import numpy as np


def name(s: str) -> str:
    """Stem of a path-like string (reference: utils.py:53-54)."""
    return str(s).split("/")[-1].split(".")[0]


def info(x, label: str | None = None) -> None:
    """Print an array's min, mean, max and shape (reference: utils.py:10-50)."""
    x = np.asarray(x)
    prefix = f"{label} " if label else ""
    print(f"{prefix}{x.min():.2f} {x.mean():.2f} {x.max():.2f} {tuple(x.shape)}")


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Gaussian-weighted SSIM (11x11, sigma 1.5, the standard
    formulation), in f64 on the host: a scorer, not a device op.  Inputs
    are HWC (or NHWC) uint8/float arrays on the 0..data_range scale.
    ``python -m maua_style_tpu_torch.fidelity`` scores with it."""
    from scipy.ndimage import gaussian_filter

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    sigma = (0,) * (a.ndim - 3) + (1.5, 1.5, 0)

    def blur(x):
        return gaussian_filter(x, sigma=sigma, truncate=3.5)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a**2
    var_b = blur(b * b) - mu_b**2
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def wrapping_indices(length: int, start: int, window: int) -> np.ndarray:
    """Indices of a circular window over the leading axis (reference:
    utils.py:76-85 ``wrapping_slice``): ``window`` indices from ``start``,
    wrapping around at ``length``; a length-1 axis always yields index 0."""
    if length == 1:
        return np.zeros(min(window, 1) if window >= 1 else 0, dtype=np.int64)
    if start + window <= length:
        return np.arange(start, start + window, dtype=np.int64)
    return np.concatenate(
        [np.arange(start, length, dtype=np.int64), np.arange(0, (start + window) % length, dtype=np.int64)]
    )


def wrapping_slice(tensor, start: int, window: int, return_indices: bool = False):
    """Circular slice along the leading axis (reference: utils.py:76-85),
    or its indices."""
    idx = wrapping_indices(tensor.shape[0], start, window)
    if tensor.shape[0] == 1:
        idx = np.zeros(1, dtype=np.int64)
    if return_indices:
        return idx
    return tensor[idx]


__all__ = ["name", "info", "ssim", "wrapping_indices", "wrapping_slice"]
