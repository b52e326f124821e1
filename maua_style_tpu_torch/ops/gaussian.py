"""Separable Gaussian filtering equal to ``scipy.ndimage.gaussian_filter``
(JAX counterpart: maua_style_tpu/ops/gaussian.py).

The taps are scipy's: radius ``int(truncate * sigma + 0.5)``, normalised
Gaussian weights.  Boundary modes follow scipy: ``reflect`` repeats the
edge sample (numpy's ``symmetric``, not torch's ``reflect`` pad), ``wrap``
is periodic and ``nearest`` repeats the edge.  The padded indices come from
modular arithmetic, so a radius larger than the axis (sigma 5 on a tiny
frame) reflects as often as it needs to, as scipy and ``jnp.pad`` do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def padded_indices(length: int, radius: int, mode: str) -> np.ndarray:
    """Source index of each of the ``length + 2 * radius`` padded positions."""
    i = np.arange(-radius, length + radius)
    if mode == "reflect":  # period 2L: L-1 ... 0 | 0 ... L-1 | L-1 ... 0
        j = np.mod(i, 2 * length)
        return np.where(j < length, j, 2 * length - 1 - j)
    if mode == "wrap":
        return np.mod(i, length)
    if mode == "nearest":
        return np.clip(i, 0, length - 1)
    raise ValueError(f"unsupported mode {mode!r}; one of reflect, wrap, nearest")


def _conv1d_along(x: torch.Tensor, kernel: np.ndarray, axis: int, mode: str) -> torch.Tensor:
    radius = (kernel.shape[0] - 1) // 2
    if radius == 0:
        return x
    idx = torch.from_numpy(padded_indices(x.shape[axis], radius, mode)).to(x.device)
    xp = torch.movedim(x.index_select(axis, idx), axis, -1)
    lead = xp.shape[:-1]
    k = torch.from_numpy(kernel).to(device=x.device, dtype=torch.float32).view(1, 1, -1)
    out = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]).float(), k)  # symmetric kernel: correlation == convolution
    return torch.movedim(out.reshape(*lead, -1), -1, axis).to(x.dtype)


def gaussian_blur(x: torch.Tensor, sigma, mode: str = "reflect", truncate: float = 4.0) -> torch.Tensor:
    """``sigma`` is a scalar (all axes) or one value per axis; axes with
    sigma <= 0 are left as they are (scipy treats sigma 0 as identity)."""
    if np.isscalar(sigma):
        sigmas = [float(sigma)] * x.dim()
    else:
        sigmas = [float(s) for s in sigma]
        if len(sigmas) != x.dim():
            raise ValueError(f"sigma has {len(sigmas)} entries for {x.dim()}-d input")
    for axis, s in enumerate(sigmas):
        if s > 0:
            x = _conv1d_along(x, _gaussian_kernel1d(s, truncate), axis, mode)
    return x


__all__ = ["gaussian_blur", "padded_indices"]
