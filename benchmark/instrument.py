"""Instrumentation the benchmark puts around the program from its own files
(the program is not edited): patching a callable for the length of a
block, host spans as ``torch.profiler.record_function`` ranges, the
synchronising-call counter, and the reduction of a profiler trace to the
numbers the per-layer readers take.

``patched`` and ``counting_syncs`` are copied from ``chip_smoke.py``
(``patched``, ``counting_syncs``); ``summarize``'s busy time is
``chip_smoke.device_profile``'s union of device intervals."""

from __future__ import annotations

import bisect
import collections
import contextlib
import heapq
import warnings

import torch
from torch.profiler import record_function

SPAN = "bench."  # prefix of every range the benchmark opens
UNIT = SPAN + "unit"  # the profiled unit: one image, or one call


@contextlib.contextmanager
def patched(*targets):
    """While inside, ``obj.name`` calls ``wrapper(original, *args,
    **kwargs)`` for each (obj, name, wrapper); the originals come back on
    exit.  The replacement is a plain function, so a method patched on a
    class still gets its ``self``."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for (obj, name, fn), (_, _, wrapper) in zip(saved, targets):
        def call(*a, _fn=fn, _wrapper=wrapper, **kw):
            return _wrapper(_fn, *a, **kw)

        setattr(obj, name, call)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


class LastUpdate:
    """``patched`` targets that keep the optimiser's update of the last step
    of each ``StyleEngine.optimize`` call (nothing is kept during the
    steps, so the program's peak memory does not change); ``take()``
    hands it over as a (1, H, W, 3) host array."""

    def __init__(self):
        self.kept, self.left = None, 0

    def hooks(self) -> list:
        from maua_style_tpu_torch.engine import LBFGS, Adam, StyleEngine

        def each_call(fn, engine, content, styles, init, num_iters, **kw):
            self.kept, self.left = None, int(num_iters)
            return fn(engine, content, styles, init, num_iters, **kw)

        def update(fn, opt, g, state):
            upd, state = fn(opt, g, state)
            self.left -= 1
            if self.left == 0:
                self.kept = upd
            return upd, state

        return [(StyleEngine, "optimize", each_call), (LBFGS, "update", update), (Adam, "update", update)]

    def take(self):
        kept, self.kept = self.kept, None
        return kept.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def labelled(label: str):
    """A ``patched`` wrapper that runs the call inside the range
    ``bench.<label>``."""
    def wrapper(fn, *a, **kw):
        with record_function(SPAN + label):
            return fn(*a, **kw)

    return wrapper


@contextlib.contextmanager
def counting_syncs(into: dict):
    """While inside, ``torch.cuda.set_sync_debug_mode("warn")``; on exit
    ``into["total"]`` holds the synchronising calls it flagged (a whole-
    device ``torch.cuda.synchronize()`` is not flagged)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield into
        finally:
            torch.cuda.set_sync_debug_mode("default")
    into["total"] = into.get("total", 0) + sum("synchroniz" in str(w.message) for w in caught)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", SPAN))


def _inside(ranges: dict, thread: int, start: int, end: int) -> bool:
    """Whether [start, end] lies in one of ``ranges[thread]`` (sorted,
    non-overlapping (start, end) pairs)."""
    rs = ranges.get(thread)
    if not rs:
        return False
    i = bisect.bisect_right(rs, (start, float("inf"))) - 1
    return i >= 0 and rs[i][1] >= end


def summarize(prof) -> dict:
    """The profiled unit's numbers from a ``torch.profiler`` run, read from
    its raw events (building the profiler's own event tree costs minutes
    at hundreds of thousands of kernels): the unit's span (µs), device busy
    time (the union of device intervals within it), the kernel count and
    device time by kernel name, device time of the kernels launched under
    the convolutions' ATen operators and under the optimiser's range (a
    kernel's launching operator is the CPU operator its linked correlation
    id names), the Gram kernel's device time, the device time of every
    kernel by name (``kernel_us``: copies and fills left out), and the idle
    gaps, each named by the innermost benchmark range open on the host at
    its middle."""
    cuda = torch.autograd.DeviceType.CUDA
    unit, host, dev = None, [], []
    ops: dict[int, tuple] = {}
    conv = collections.defaultdict(list)
    optim = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not name.startswith(SPAN):
                dev.append((start, end, name, e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0:  # an operator or range, not a runtime call
            thread = e.start_thread_id()
            ops[e.correlation_id()] = (thread, start, end)
            if name == UNIT:
                unit = (start, end)
            elif name.startswith(SPAN):
                host.append((start, end, name[len(SPAN):]))
                if name == SPAN + "optimizer":
                    optim[thread].append((start, end))
            elif name in ("aten::convolution", "aten::convolution_backward"):
                conv[thread].append((start, end))
    if unit is None:
        raise RuntimeError("the profile holds no bench.unit range")
    for ranges in (conv, optim):
        for rs in ranges.values():
            rs.sort()
    dev.sort()
    spans, conv_ns, opt_ns = [], 0, 0
    by_kernel = collections.Counter()
    kernels = gram_ns = 0
    for a, b, name, link in dev:
        by_kernel[name] += b - a
        if _is_kernel(name):
            kernels += 1
            if "gram_partial" in name or "gram_reduce" in name:
                gram_ns += b - a
        op = ops.get(link)
        if op is not None:
            conv_ns += (b - a) * _inside(conv, op[0], op[1], op[2])
            opt_ns += (b - a) * _inside(optim, op[0], op[1], op[2])
        a, b = max(a, unit[0]), min(b, unit[1])
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy = sum(b - a for a, b in spans)
    edges = [unit[0]] + [x for s in spans for x in s] + [unit[1]]
    longest = heapq.nlargest(10, ((b - a, a) for a, b in zip(edges[::2], edges[1::2]) if b > a))
    gaps = []
    for length, a in longest:
        mid = a + length / 2
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        gaps.append((length, min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "host"))
    return {
        "window_us": (unit[1] - unit[0]) / 1e3,
        "busy_us": busy / 1e3,
        "kernels": kernels,
        "conv_us": conv_ns / 1e3,
        "optimizer_us": opt_ns / 1e3,
        "gram_us": gram_ns / 1e3,
        "kernel_us": {n: ns / 1e3 for n, ns in by_kernel.items() if _is_kernel(n)},
        "device_ops": [[n[:120], ns / 1e9] for n, ns in by_kernel.most_common(10)],
        "idle_gaps": [[n, ns / 1e9] for ns, n in gaps],
    }
