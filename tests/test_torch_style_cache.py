"""The engine's style-target cache (``StyleEngine.style_targets``): a call
hits only when its blend weights, and its styles' number, shapes and f32
values bit for bit, are those of the last capture, which the engine checks
against its own read-only host copy chunk by chunk (at the default chunk
and at one that cuts a small style into many pieces); a hit returns the
very tensors captured before, a miss captures what a fresh engine does,
and the replica of an ``optimize_frames`` row shares the copy and hits."""

import numpy as np
import pytest
import torch

from maua_style_tpu_torch import trace
from maua_style_tpu_torch.engine import StyleEngine, optimize
from maua_style_tpu_torch.parallel import build_mesh
from test_torch_engine import _engine, _images
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CPU = torch.device("cpu")
COUNTERS = ("engine.style_cache.hit", "engine.style_cache.miss", "engine.style_compare_bytes")


def _counts() -> dict:
    return {k: trace.counter(k) for k in COUNTERS}


def _since(before: dict) -> tuple:
    return tuple(trace.counter(k) - before[k] for k in COUNTERS)


def _f32_bytes(styles) -> int:
    return sum(np.asarray(s, np.float32).nbytes for s in styles)


def _assert_same_targets(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for layer, t in want.items():
        assert torch.equal(got[layer], t), layer


def _signed_zero(s, sign):
    out = s.copy()
    out[0, 5, 6, 1] = sign * 0.0
    return out


_WIDE = np.random.default_rng(3).normal(0, 40, (1, 24, 56, 3)).astype(np.float32)

# first call's (styles, weights), second call's, whether it hits and how much
# of the second call's styles the check reads
CASES = {
    "equal_copy": (lambda s: ([s], [1.0], [s.copy()], [1.0]), True, "all"),
    "float64_of_the_same_f32": (lambda s: ([s], [1.0], [s.astype(np.float64)], [1.0]), True, "all"),
    "non_contiguous_view": (lambda s: ([np.ascontiguousarray(_WIDE[:, :, ::2])], [1.0], [_WIDE[:, :, ::2]], [1.0]),
                            True, "all"),
    "view_first": (lambda s: ([_WIDE[:, :, ::2]], [1.0], [np.ascontiguousarray(_WIDE[:, :, ::2])], [1.0]), True, "all"),
    "blend_weights": (lambda s: ([s], [1.0], [s], [0.5]), False, "none"),
    "shape": (lambda s: ([s], [1.0], [s[:, :20]], [1.0]), False, "none"),
    "number_of_styles": (lambda s: ([s], [1.0], [s, s.copy()], [0.5, 0.5]), False, "none"),
    "negative_zero": (lambda s: ([_signed_zero(s, 1)], [1.0], [_signed_zero(s, -1)], [1.0]), False, "some"),
}


@pytest.mark.parametrize("chunk", [16, optimize._COMPARE_CHUNK])
@pytest.mark.parametrize("case", list(CASES))
def test_a_call_hits_only_on_the_same_f32_styles_and_weights(case, chunk, monkeypatch):
    monkeypatch.setattr(optimize, "_COMPARE_CHUNK", chunk)
    make, hits, reads = CASES[case]
    styles, weights, styles2, weights2 = make(_images()[1])
    engine = _engine("adam")
    before = _counts()
    first = engine.style_targets(styles, weights)
    assert _since(before) == (0, 1, 0)  # a first call compares nothing

    before = _counts()
    second = engine.style_targets(styles2, weights2)
    hit, miss, read = _since(before)
    assert (hit, miss) == ((1, 0) if hits else (0, 1))
    if reads == "all":
        assert read == _f32_bytes(styles2)
    elif reads == "none":
        assert read == 0
    else:
        assert 0 < read <= _f32_bytes(styles2)
    if hits:
        assert second is first
    else:
        _assert_same_targets(second, _engine("adam").style_targets(styles2, weights2))


def test_a_change_in_place_after_a_call_misses_and_recaptures():
    style = _images()[1]
    engine = _engine("adam")
    first = {l: t.clone() for l, t in engine.style_targets([style], [1.0]).items()}
    snap = engine._style_cache.styles[0]
    assert not snap.flags.writeable and not np.shares_memory(snap, style)
    style[0, 3, 4, 1] += 1.0
    before = _counts()
    second = engine.style_targets([style], [1.0])
    assert _since(before)[:2] == (0, 1)
    _assert_same_targets(second, _engine("adam").style_targets([style], [1.0]))
    assert any(not torch.equal(second[l], t) for l, t in first.items())


def test_the_replica_of_an_optimize_frames_row_shares_the_copy_and_hits(monkeypatch):
    """frames:2,space:2 on ``[cpu] * 4``, the second row's share on a
    replica as on distinct cards (``test_optimize_frames_second_row_on_a_replica``
    makes the lookup the same way): the engine misses once, then its own
    row and the replica each hit, each check reading the whole style."""
    rng = np.random.default_rng(4)
    contents = rng.integers(0, 255, (4, 48, 48, 3)).astype(np.uint8)
    style = rng.random((1, 20, 20, 3), np.float32) * 255 - 128
    engine = _engine("adam", mesh=build_mesh([CPU] * 4, [("frames", 2), ("space", 2)]))
    replica_of = StyleEngine._replica
    rows = []

    def as_on_distinct_cards(self, row):
        if self is engine and len(row) > 1:
            rows.append(row)
            if len(rows) == 2:
                own, self.band_devices = self.band_devices, None
                try:
                    return replica_of(self, row)
                finally:
                    self.band_devices = own
        return replica_of(self, row)

    monkeypatch.setattr(StyleEngine, "_replica", as_on_distinct_cards)
    before = _counts()
    engine.optimize_frames(contents, [style], 2, out_hw=(48, 48), init_mode="content", blend_weights=[1.0])
    assert _since(before) == (2, 1, 2 * style.nbytes)
    replica = engine._replicas[(CPU, CPU)]
    entry, copy = engine._style_cache, replica._style_cache
    assert copy.weights == entry.weights and all(a is b for a, b in zip(copy.styles, entry.styles))
    for layer, t in entry.targets.items():
        assert torch.equal(copy.targets[layer], t)
