"""The port's spans and counters.

``span(name, **attrs)`` marks a step of the host's work (names are
``<layer>.<step>``: ``pipeline.scale``, ``engine.chunk``, ``net.forward``);
``count(name, n)`` adds to a counter (``weights.upload_bytes``,
``gram.launches``).

Tracing is on while a ``torch.profiler`` records, or after ``enable()``.
Off, a span site reads one flag and returns a shared null context: no
clock, no record, no profiler range.  On, each span appends a record
(name, start_ns, end_ns, parent index, attrs) to its root: a span opened
while none is open (on this thread) starts a root, which holds the
records and counters of one request (a CLI job, an ``optimize`` call).
The newest 64 roots are kept, each with at most 100,000 records and a
count of those ``dropped`` past that.  Times are ``time.time_ns()``, the
clock of kineto's event times, so a record lines up with the profiler's
trace; while a profiler records, a span also opens a profiler range of the
same name.  The range is a function-scope ``RecordFunction``: a
``record_function`` (user scope) would also put a ``gpu_user_annotation``
event on the device's timeline, which trace readers would take for a
kernel.

Counters always add to the process's totals (``counter(name)``); while
tracing is on they also add to the open root's ``counters``."""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

MAX_ROOTS = 64
MAX_RECORDS = 100_000

# a named profiler range that puts nothing on the device's timeline
_Range = torch._C._profiler._RecordFunctionFast

_enabled = False
_roots: collections.deque = collections.deque(maxlen=MAX_ROOTS)
_totals: dict[str, int] = {}
_local = threading.local()


class Root:
    """One request's records, ``[name, start_ns, end_ns, parent, attrs]``
    each (record 0 the root's own span, parent -1), its counters and the
    records dropped past ``MAX_RECORDS``."""

    def __init__(self):
        self.records: list[list] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0

    @property
    def name(self) -> str:
        return self.records[0][0]

    def spans(self, name: str) -> list[list]:
        return [r for r in self.records if r[0] == name]

    def to_dict(self) -> dict:
        keys = ("name", "start_ns", "end_ns", "parent", "attrs")
        return {"records": [dict(zip(keys, r)) for r in self.records], "counters": dict(self.counters),
                "dropped": self.dropped}


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "root", "index", "record", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        if stack:
            self.root, parent = stack[-1].root, stack[-1].index
        else:
            self.root, parent = Root(), -1
            _roots.append(self.root)
        records = self.root.records
        if len(records) < MAX_RECORDS:
            self.index, self.record = len(records), [self.name, 0, 0, parent, self.attrs]
            records.append(self.record)
        else:  # past the cap: counted, and its children hang from its parent
            self.root.dropped += 1
            self.index, self.record = parent, None
        self.range = _Range(self.name) if _profiler._is_profiler_enabled else None
        if self.range is not None:
            self.range.__enter__()
        stack.append(self)
        if self.record is not None:
            self.record[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.record[2] = time.time_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def on() -> bool:
    """Whether spans record: after ``enable()``, or while a profiler records."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context manager that records the block as ``name`` while tracing
    is on; a shared null context otherwise."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``: to the process's total, and while
    tracing is on to the open root's."""
    _totals[name] = _totals.get(name, 0) + n
    if _enabled or _profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            c = stack[-1].root.counters
            c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    """The process's total of the counter ``name``."""
    return _totals.get(name, 0)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def roots() -> list[Root]:
    """The kept roots, newest last."""
    return list(_roots)


def total_ns(root: Root, name: str) -> int:
    """The summed time of the root's spans called ``name``."""
    return sum(r[2] - r[1] for r in root.spans(name))


def self_ns(root: Root, name: str) -> int:
    """The summed time of the root's spans called ``name``, less the parts
    their children cover."""
    own = {i for i, r in enumerate(root.records) if r[0] == name}
    children = sum(r[2] - r[1] for r in root.records if r[3] in own)
    return total_ns(root, name) - children


__all__ = ["span", "count", "counter", "enable", "disable", "on", "roots", "self_ns", "total_ns", "Root"]
