"""Host-side bilinear resize matching torch ``F.interpolate(mode="bilinear",
align_corners=False)`` (JAX counterpart: maua_style_tpu/ops/resize.py,
``resize_bilinear_np``).

Torch quirk reproduced: with ``scale_factor=s`` torch uses ``1/s`` directly
as the coordinate scale instead of the in/out size ratio.  Arrays are
(..., H, W, C) numpy; the resize is a 2-tap gather per axis.
"""

from __future__ import annotations

import math

import numpy as np


def scale_shape(hw: tuple[int, int], scale_factor: float) -> tuple[int, int]:
    """Output (H, W) for a scale factor, matching torch's floor semantics."""
    return (int(math.floor(hw[0] * scale_factor)), int(math.floor(hw[1] * scale_factor)))


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


__all__ = ["resize_bilinear_np", "scale_shape"]
