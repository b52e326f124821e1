"""The port's spans and counters (``maua_style_tpu_torch/trace.py``): off,
a span records nothing and opens no profiler range; on, records nest
under roots with parent indices, self time, the per-root cap and counters;
under ``torch.profiler`` every span is a kineto event of its name on the
records' clock; and the engine's and the CLI's spans (``--profile_dir``'s
``spans.json`` and one trace file per profiled chunk)."""

import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from maua_style_tpu_torch import style, trace
from test_torch_engine import _engine, _images
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


@pytest.fixture
def traced(monkeypatch):
    """Tracing on, with an empty store of roots, for one test."""
    monkeypatch.setattr(trace, "_roots", type(trace._roots)(maxlen=trace.MAX_ROOTS))
    monkeypatch.setattr(trace, "_totals", dict(trace._totals))
    trace.enable()
    yield
    trace.disable()


def test_off_a_span_reads_no_clock_and_opens_no_range(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("called while tracing is off")

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read while tracing is off")

    monkeypatch.setattr(trace, "_Range", refuse)
    monkeypatch.setattr(trace, "time", NoClock())
    assert not trace.on()
    n = len(trace.roots())
    first = trace.span("engine.step")
    with first:
        with trace.span("net.forward", size=3):
            pass
    assert trace.span("losses") is first  # one shared null context
    assert len(trace.roots()) == n
    before = trace.counter("test.off")
    trace.count("test.off", 3)
    assert trace.counter("test.off") == before + 3


def test_on_records_nest_under_roots_with_self_time(traced):
    with trace.span("pipeline.img_img"):
        with trace.span("pipeline.scale", size=32):
            with trace.span("engine.chunk"):
                time.sleep(0.002)
            with trace.span("engine.chunk"):
                pass
        trace.count("weights.uploads")
        trace.count("weights.upload_bytes", 10)
    with trace.span("engine.optimize"):
        trace.count("weights.upload_bytes", 5)
    first, second = trace.roots()
    assert first.name == "pipeline.img_img" and second.name == "engine.optimize"
    assert [(r[0], r[3]) for r in first.records] == [("pipeline.img_img", -1), ("pipeline.scale", 0),
                                                     ("engine.chunk", 1), ("engine.chunk", 1)]
    assert first.records[1][4] == {"size": 32}
    assert all(r[1] <= r[2] for r in first.records)
    assert first.records[0][1] <= first.records[1][1] and first.records[1][2] <= first.records[0][2]
    scale, chunks = first.records[1], first.spans("engine.chunk")
    assert trace.total_ns(first, "engine.chunk") == sum(r[2] - r[1] for r in chunks) >= 2_000_000
    assert trace.self_ns(first, "pipeline.scale") == scale[2] - scale[1] - sum(r[2] - r[1] for r in chunks)
    assert first.counters == {"weights.uploads": 1, "weights.upload_bytes": 10}
    assert second.counters == {"weights.upload_bytes": 5}
    assert trace.counter("weights.upload_bytes") >= 15
    json.dumps(first.to_dict())


def test_roots_and_records_are_bounded(traced, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 4)
    with trace.span("engine.optimize"):
        for _ in range(5):
            with trace.span("engine.step"):
                with trace.span("net.forward"):
                    pass
    root = trace.roots()[-1]
    assert len(root.records) == 4 and root.dropped == 7
    assert [r[3] for r in root.records] == [-1, 0, 1, 0]
    for _ in range(trace.MAX_ROOTS + 3):
        with trace.span("engine.optimize"):
            pass
    assert len(trace.roots()) == trace.MAX_ROOTS and trace.roots()[0] is not root


def test_under_the_profiler_every_span_is_a_kineto_event():
    n = len(trace.roots())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        with trace.span("engine.optimize"):
            with trace.span("engine.step"):
                torch.ones(8).add_(1)
            trace.count("engine.iterations")
    assert not trace.on()
    roots = trace.roots()
    assert len(roots) == n + 1 and roots[-1].counters == {"engine.iterations": 1}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name, start, end, _, _ in roots[-1].records:
        e = events[name]
        assert abs(e.start_ns() - start) < 1_000_000 and abs(e.end_ns() - end) < 1_000_000


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_an_optimize_call_is_one_root(traced, optimizer):
    content, style_img, init = _images()
    iters = 4
    _engine(optimizer).optimize(content, [style_img], init, iters, print_iter=2)
    # the engine's own build, outside any span, is a root of its own
    upload, root = trace.roots()
    assert upload.name == "weights.upload" and upload.counters["weights.uploads"] == 1
    assert root.name == "engine.optimize"
    names = [r[0] for r in root.records]
    step = {i for i, r in enumerate(root.records) if r[0] == "engine.step"}
    for name in ("engine.step", "net.backward", "optimizer.update", "losses"):
        assert names.count(name) == iters, name
    assert sum(r[0] == "net.forward" and r[3] in step for r in root.records) == iters
    assert len(root.spans("engine.chunk")) == 2 and [r[4] for r in root.spans("engine.chunk")] == [{"iters": 2}] * 2
    assert [r[4] for r in root.spans("engine.capture")] == [{"kind": "content"}, {"kind": "style"}]
    assert len(root.spans("engine.style_key")) == 1
    c = root.counters
    assert c["engine.iterations"] == iters and c["engine.style_cache.miss"] == 1
    assert c["engine.h2d_bytes"] == content.nbytes + style_img.nbytes + init.nbytes
    assert c["engine.d2h_bytes"] == init.nbytes


def test_a_second_call_hits_the_style_cache(traced):
    content, style_img, init = _images()
    engine = _engine("adam")
    engine.optimize(content, [style_img], init, 1)
    engine.optimize(content, [style_img], init, 1)
    assert trace.roots()[-1].counters["engine.style_cache.hit"] == 1
    assert "engine.style_cache.miss" not in trace.roots()[-1].counters


def test_cli_profile_dir_writes_spans_and_a_trace_per_chunk(traced, tmp_path):
    with trace.span("engine.optimize"):  # an earlier root, not the job's
        pass
    yy, xx = np.mgrid[0:40, 0:48]
    Image.fromarray(np.stack([xx * 5 % 256, yy * 6 % 256, (xx + yy) % 256], -1).astype(np.uint8)).save(tmp_path / "c.png")
    Image.fromarray(np.stack([yy * 6 % 256, xx * 5 % 256, xx % 256], -1).astype(np.uint8)).save(tmp_path / "s.png")
    prof = tmp_path / "prof"
    style.main(["--content", str(tmp_path / "c.png"), "--style", str(tmp_path / "s.png"),
                "--output_dir", str(tmp_path / "out"), "--image_sizes", "24,32", "--num_iters", "2,2",
                "--optimizer", "adam", "--gpu", "c", "--allow_random_weights", "--model_file", "vgg19",
                "--content_layers", "relu2_1", "--style_layers", "relu1_1,relu2_1",
                "--scaling_args", str(tmp_path / "none.json"), "--profile_dir", str(prof)])
    assert not trace.on()
    assert sorted(os.listdir(prof)) == ["spans.json", "trace.json", "trace_1.json"]
    (job,) = json.loads((prof / "spans.json").read_text())
    assert job["records"][0]["name"] == "pipeline.img_img" and job["dropped"] == 0
    names = [r["name"] for r in job["records"]]
    assert [r["attrs"] for r in job["records"] if r["name"] == "pipeline.scale"] == [{"size": 24}, {"size": 32}]
    assert names.count("engine.build") == 2 and names.count("weights.upload") == 2
    assert names.count("engine.optimize") == 2 and names.count("pipeline.save") == 2
    assert job["counters"]["weights.upload_bytes"] > 0 and job["counters"]["weights.uploads"] == 2
    assert job["counters"]["engine.iterations"] == 4
