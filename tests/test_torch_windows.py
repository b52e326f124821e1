"""img_vid's window schedule: the port's engine/windows.py and
utils.wrapping_indices against the JAX package's, exactly, over pastiche
lengths shorter and longer than the window, several style lengths (a
1-frame style among them) and windows."""

import numpy as np
import pytest

from maua_style_tpu.engine import windows as jw
from maua_style_tpu.utils import wrapping_indices as jax_wrapping_indices
from maua_style_tpu_torch.engine import windows as tw
from maua_style_tpu_torch.utils import wrapping_indices
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CASES = [  # (pastiche frames, style lengths, gram_frame_window)
    (48, [24], 18),
    (48, [24], 9),
    (48, [24], 7),
    (24, [24, 1], 18),
    (8, [8], 4),
    (5, [6, 3], 2),
    (3, [8], 4),  # T < gfw
    (1, [8], 4),  # a 1-frame pastiche
    (2, [1], 3),
    (17, [30, 5, 1], 6),
]


@pytest.mark.parametrize("t,style_lens,gfw", CASES)
def test_window_schedule_matches_jax(t, style_lens, gfw):
    windows = tw.compute_windows(t, style_lens, gfw)
    assert windows == jw.compute_windows(t, style_lens, gfw)
    assert len(windows) == 1 + len(style_lens)
    for w, start in enumerate(windows[0]):
        idx = wrapping_indices(t, start, gfw)
        np.testing.assert_array_equal(idx, jax_wrapping_indices(t, start, gfw))
        assert idx.dtype == np.int64 and ((idx >= 0) & (idx < t)).all()
        if w == 0:
            continue
        overlaps = tw.window_overlaps(windows[0], w, start, gfw, t)
        assert overlaps == jw.window_overlaps(windows[0], w, start, gfw, t)
        np.testing.assert_array_equal(tw.overlap_grad_mask(len(idx), w, *overlaps),
                                      jw.overlap_grad_mask(len(idx), w, *overlaps))
    np.testing.assert_array_equal(tw.overlap_grad_mask(gfw, 0, 3, 2), np.ones((gfw, 1, 1, 1), np.float32))


@pytest.mark.parametrize("length,start,window", [(10, 0, 4), (10, 8, 4), (10, 9, 10), (1, 0, 5), (1, 0, 0),
                                                 (3, 2, 7), (24, 20, 18), (6, 0, 0)])
def test_wrapping_indices_matches_jax(length, start, window):
    got = wrapping_indices(length, start, window)
    want = jax_wrapping_indices(length, start, window)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
