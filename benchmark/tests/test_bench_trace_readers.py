"""The readers of the program's spans and counters, on a root built by
hand: each reads the newest root of ``maua_style_tpu_torch.trace``, and
nothing where the program kept none; and ``instrument.summarize`` on
profiler events built by hand."""

from __future__ import annotations

import collections
import types

import pytest
import torch

from benchmark import harness, instrument

trace = pytest.importorskip("maua_style_tpu_torch.trace")

S = 1_000_000_000  # ns


def _root(*records, counters=None):
    root = trace.Root()
    root.records = [list(r) for r in records]
    root.counters = dict(counters or {})
    return root


@pytest.fixture
def roots(monkeypatch):
    store = collections.deque(maxlen=trace.MAX_ROOTS)
    monkeypatch.setattr(trace, "_roots", store)
    return store


def _read(metric):
    return harness.reader(metric).read(None)


def _image():
    """A CLI image of two scales: 20 s in all, 12 s in two chunks, two
    engine builds, two captures and a style key."""
    return _root(("pipeline.img_img", 0, 20 * S, -1, {}),
                 ("pipeline.scale", 1 * S, 9 * S, 0, {"size": 256}),
                 ("engine.build", 1 * S, 2 * S, 1, {}),
                 ("engine.optimize", 2 * S, 8 * S, 1, {}),
                 ("engine.capture", 2 * S, 3 * S, 3, {"kind": "content"}),
                 ("engine.capture", 3 * S, 4 * S, 3, {"kind": "style"}),
                 ("engine.style_key", 3 * S, 3 * S + S // 4, 5, {}),
                 ("engine.chunk", 4 * S, 8 * S, 3, {"iters": 25}),
                 ("pipeline.scale", 10 * S, 19 * S, 0, {"size": 512}),
                 ("engine.build", 10 * S, 11 * S + S // 2, 8, {}),
                 ("engine.chunk", 11 * S + S // 2, 19 * S + S // 2, 8, {"iters": 25}),
                 counters={"weights.upload_bytes": 3 * 2**20, "weights.uploads": 2})


@pytest.mark.parametrize("metric,want", [
    ("outside_loop_s.image", 8.0), ("outside_loop_s.scale", 8.0), ("capture_s.image", 2.0), ("capture_s.scale", 2.0),
    ("style_key_s.scale", 0.25), ("engine_build_s.image", 2.5), ("weight_upload_mb.image", 3.0)])
def test_each_reader_reads_the_newest_root(roots, metric, want):
    roots.append(_root(("engine.optimize", 0, 100 * S, -1, {}), counters={"weights.upload_bytes": 7}))
    roots.append(_image())
    assert _read(metric) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["outside_loop_s.image", "capture_s.scale", "style_key_s.scale",
                                    "engine_build_s.image", "weight_upload_mb.image"])
def test_nothing_without_a_root(roots, metric):
    assert _read(metric) is None


@pytest.mark.parametrize("metric", ["capture_s.scale", "style_key_s.scale", "engine_build_s.image",
                                    "weight_upload_mb.image"])
def test_nothing_where_the_root_lacks_the_span_or_counter(roots, metric):
    roots.append(_root(("engine.optimize", 0, 2 * S, -1, {})))
    assert _read(metric) is None


def test_an_optimize_root_less_its_chunks(roots):
    roots.append(_root(("engine.optimize", 0, 10 * S, -1, {}), ("engine.capture", 0, 3 * S, 0, {"kind": "style"}),
                       ("engine.chunk", 3 * S, 9 * S, 0, {"iters": 25})))
    assert _read("outside_loop_s.scale") == pytest.approx(4.0)


def _event(name, start, end, device, corr=0, link=0):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                                 device_type=lambda: device, correlation_id=lambda: corr,
                                 linked_correlation_id=lambda: link, start_thread_id=lambda: 1)


def test_summarize_times_every_kernel_by_name():
    """Twelve kernels, one a copy: ``kernel_us`` holds all eleven others
    (``device_ops`` only the ten longest, copies included)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_event(instrument.UNIT, 0, 100_000, cpu, corr=1)]
    events += [_event(f"kernel_{i}", 1000 * i, 1000 * i + 100 * (i + 1), cuda, link=1) for i in range(11)]
    events.append(_event("Memcpy HtoD (Pageable -> Device)", 50_000, 60_000, cuda, link=1))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    summary = instrument.summarize(prof)
    assert summary["kernel_us"] == {f"kernel_{i}": pytest.approx(0.1 * (i + 1)) for i in range(11)}
    assert summary["kernels"] == 11 and len(summary["device_ops"]) == 10
    assert summary["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(1e-5)]
