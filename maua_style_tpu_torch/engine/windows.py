"""Temporal window schedule of img_vid (JAX counterpart:
maua_style_tpu/engine/windows.py; reference: optim.py:114-123, 149-156,
215-219).

A T-frame pastiche is optimised in circular ``gram_frame_window``-sized
windows whose starts are spaced linearly over each style video's length;
frames that earlier windows already styled keep a zero gradient.  Host code
only.
"""

from __future__ import annotations

import math

import numpy as np


def compute_windows(pastiche_len: int, style_lens: list[int], gram_frame_window: int) -> list[list[int]]:
    """Window starts for the pastiche (row 0) and each style video:
    ceil(T / gfw) + 1 starts per row, ceil(framestep * n) with framestep =
    (len - gfw / 2) / num_windows; a length-1 row pins to start 0.  The
    extra window wraps around and covers the seam again."""
    num_windows = math.ceil(pastiche_len / gram_frame_window)
    lens = [pastiche_len] + list(style_lens)
    framestep = [(l - gram_frame_window / 2) / num_windows for l in lens]
    return [
        [math.ceil(framestep[idx] * n) for n in range(num_windows + 1)] if lens[idx] != 1 else [0] * (num_windows + 1)
        for idx in range(len(lens))
    ]


def window_overlaps(windows0: list[int], w: int, window_start: int, gfw: int, total: int) -> tuple[int, int]:
    """(front_overlap, end_overlap): frames of window ``w`` that the previous
    window and the wrap-around already cover (reference optim.py:151-156)."""
    front_overlap = windows0[w - 1] + gfw - window_start  # window 0 is never masked
    end_overlap = (window_start + gfw) % total if window_start + gfw >= total else 0
    return front_overlap, end_overlap


def overlap_grad_mask(gfw: int, w: int, front_overlap: int, end_overlap: int) -> np.ndarray:
    """(gfw, 1, 1, 1) multiplicative gradient mask, 0 on the frames earlier
    windows styled (the reference zeroes pastiche.grad there)."""
    mask = np.ones((gfw, 1, 1, 1), np.float32)
    if w != 0:
        mask[: max(0, min(front_overlap, gfw))] = 0.0
        if end_overlap > 0:
            mask[-min(end_overlap, gfw) :] = 0.0
    return mask


__all__ = ["compute_windows", "window_overlaps", "overlap_grad_mask"]
