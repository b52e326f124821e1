"""Small shared helpers (JAX counterpart: maua_style_tpu/utils)."""

from __future__ import annotations

import numpy as np


def name(s: str) -> str:
    """Stem of a path-like string (reference: utils.py:53-54)."""
    return str(s).split("/")[-1].split(".")[0]


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


__all__ = ["name", "wrapping_indices"]
