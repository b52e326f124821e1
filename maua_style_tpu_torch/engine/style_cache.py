"""An engine's style-target cache (``StyleCache``), with no device code: the engine captures and uploads."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np

from .. import trace

# elements of one chunk of the comparison (16 MiB of f32), and the threads
# that compare chunks (numpy's comparison releases the GIL: on the 8-core
# host of an H100 machine 4 threads compare 991 MB with a copy in ≈ 0.1 s
# where one takes ≈ 0.3)
_COMPARE_CHUNK = 1 << 22
_COMPARE_THREADS = 4


class _StyleEntry(NamedTuple):
    weights: tuple[float, ...]
    styles: tuple[np.ndarray, ...]
    targets: dict


def _chunks(a: np.ndarray, snap: np.ndarray):
    """(piece of ``a``, piece of ``snap``) views of at most ``_COMPARE_CHUNK``
    elements each, cut over the leading axes, in order."""
    if a.size <= _COMPARE_CHUNK:
        yield a, snap
        return
    row = a.size // len(a)
    if row > _COMPARE_CHUNK:
        for x, y in zip(a, snap):
            yield from _chunks(x, y)
        return
    step = _COMPARE_CHUNK // row
    for i in range(0, len(a), step):
        yield a[i:i + step], snap[i:i + step]


def _same_chunk(pair) -> bool:
    a, snap = pair
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32), snap.view(np.uint32))


def _same_f32_bits(a: np.ndarray, snap: np.ndarray, pool) -> bool:
    """Whether ``a`` as f32 equals ``snap`` (f32, C-contiguous, of its shape)
    bit for bit, so that NaN payloads and signed zeros count as they did in
    a byte hash: chunk by chunk on ``pool``'s threads, each chunk converted
    alone; at the first chunk (in order) that differs, the chunks not yet
    started are cancelled.  Counts the bytes of ``snap`` up to that chunk."""
    chunks = list(_chunks(a, snap))
    for (_, s), same in zip(chunks, pool.map(_same_chunk, chunks)):
        trace.count("engine.style_compare_bytes", s.nbytes)
        if not same:
            return False
    return True


class StyleCache:
    """One entry (``entry``, or None; engines live per scale, and per-frame
    callers pass the same style images every call): the blend weights, a
    private read-only C-contiguous f32 host copy of each style (the values
    the engine uploads) and the targets captured from them."""

    entry: _StyleEntry | None = None

    def targets(self, styles: Sequence, blend_weights: Sequence[float], capture: Callable) -> dict:
        """The entry's targets when the weights, the styles' number and
        shapes, and every style's f32 values are its; else those of a new
        entry, a snapshot of each style and ``capture(snapshots)``."""
        weights = tuple(float(bw) for bw in blend_weights)
        entry = self.entry
        with trace.span("engine.style_key"):
            arrays = [np.asarray(s) for s in styles]
            hit = (entry is not None and entry.weights == weights and len(arrays) == len(entry.styles)
                   and all(a.shape == snap.shape for a, snap in zip(arrays, entry.styles)))
            if hit:
                with ThreadPoolExecutor(_COMPARE_THREADS) as pool:
                    hit = all(_same_f32_bits(a, snap, pool) for a, snap in zip(arrays, entry.styles))
        trace.count("engine.style_cache.hit" if hit else "engine.style_cache.miss")
        if hit:
            return entry.targets
        snaps = tuple(np.array(a, np.float32, order="C") for a in arrays)  # copies, whatever the callers' arrays
        for snap in snaps:
            snap.flags.writeable = False
        self.entry = _StyleEntry(weights, snaps, capture(snaps))
        return self.entry.targets

    def copy_to(self, other: StyleCache, device) -> None:
        """``other`` (a replica's cache) takes this entry, its host snapshots
        shared and its targets copied to ``device``."""
        other.entry = self.entry._replace(targets={l: t.to(device) for l, t in self.entry.targets.items()})
