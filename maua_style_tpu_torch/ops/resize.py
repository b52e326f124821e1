"""Bilinear resize with torch ``F.interpolate(mode="bilinear",
align_corners=False)`` semantics (JAX counterpart:
maua_style_tpu/ops/resize.py, ``resize_bilinear`` and ``resize_bilinear_np``).

Torch quirk kept: with ``scale_factor=s`` torch uses ``1/s`` directly as the
coordinate scale instead of the in/out size ratio (the JAX package
reproduces it).

- ``resize_bilinear``: NCHW tensors on any device, through ``F.interpolate``
  (``recompute_scale_factor=False`` keeps the quirk).
- ``resize_bilinear_np``: host (..., H, W, C) numpy arrays, a 2-tap gather
  per axis.
- ``resize_nearest``: NCHW tensors, nearest neighbour at half-pixel centres
  (``jax.image.resize(method="nearest")``, torch's ``"nearest-exact"``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def scale_shape(hw: tuple[int, int], scale_factor: float) -> tuple[int, int]:
    """Output (H, W) for a scale factor, matching torch's floor semantics."""
    return (int(math.floor(hw[0] * scale_factor)), int(math.floor(hw[1] * scale_factor)))


def resize_bilinear(x: torch.Tensor, size: tuple[int, int] | None = None, scale_factor: float | None = None) -> torch.Tensor:
    """Resize (B, C, H, W) tensors; exactly one of ``size`` (H, W) or
    ``scale_factor`` must be given.  Computes in float32, returns x's dtype."""
    if (size is None) == (scale_factor is None):
        raise ValueError("pass exactly one of size= or scale_factor=")
    if size is not None:
        if tuple(size) == tuple(x.shape[-2:]):
            return x
        y = F.interpolate(x.float(), size=tuple(int(s) for s in size), mode="bilinear", align_corners=False, antialias=False)
    else:
        y = F.interpolate(x.float(), scale_factor=float(scale_factor), mode="bilinear", align_corners=False,
                          antialias=False, recompute_scale_factor=False)
    return y.to(x.dtype)


def _gather_coords(in_len: int, out_len: int, scale: float | None):
    inv = (1.0 / scale) if (scale is not None and scale > 0) else (in_len / out_len)
    src = np.clip((np.arange(out_len, dtype=np.float64) + 0.5) * inv - 0.5, 0.0, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    t = (src - lo).astype(np.float32)
    return lo, hi, t


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int] | None = None, scale_factor: float | None = None) -> np.ndarray:
    """Resize (..., H, W, C) arrays; exactly one of ``size`` (H, W) or
    ``scale_factor`` must be given."""
    if (size is None) == (scale_factor is None):
        raise ValueError("pass exactly one of size= or scale_factor=")
    h, w = int(x.shape[-3]), int(x.shape[-2])
    if size is None:
        size = scale_shape((h, w), scale_factor)
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w) and scale_factor is None:
        return x

    y0, y1, ty = _gather_coords(h, oh, scale_factor)
    x0, x1, tx = _gather_coords(w, ow, scale_factor)
    xf = np.asarray(x, np.float32)
    top = xf[..., y0, :, :]
    bot = xf[..., y1, :, :]
    rows = top + ty[:, None, None] * (bot - top)  # (..., oh, W, C)
    left = rows[..., :, x0, :]
    right = rows[..., :, x1, :]
    out = left + tx[None, :, None] * (right - left)
    return out.astype(x.dtype)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize (B, C, H, W) tensors to ``size`` (H, W), each output pixel the
    input pixel under its centre: floor((i + 0.5) · in / out).  Torch's
    ``"nearest"`` takes floor(i · in / out) instead."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="nearest-exact")


__all__ = ["resize_bilinear", "resize_bilinear_np", "resize_nearest", "scale_shape"]
