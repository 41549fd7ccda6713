"""Spans and counters of the port's own layers.

    rec = Recorder()
    with recording(rec):
        align_records(...)
    rec.calls, rec.total_ns, rec.self_ns, rec.counters

`span(name)` times the work inside a `with` on time.perf_counter_ns; a
span's self time is its total less that of the spans opened inside it.
`count(name, n)` adds to the counters. With no Recorder installed (the
default) `span` returns one shared no-op context and `count` returns at
once: nothing is allocated, and neither ever launches a device op nor
waits for the card. `counting(d)` routes the counts into a plain dict as
well (the drivers' `stats=`), so a caller's dict and an installed
Recorder receive the same counts through the one path.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import time

_RECORDER = contextvars.ContextVar("tpumap_torch_recorder", default=None)
# the dicts count() adds to: an installed Recorder's counters and the
# drivers' stats dicts
_COUNTS = contextvars.ContextVar("tpumap_torch_counts", default=())


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """Per span name: calls, total and self time (ns); optionally each
    span's (start_ns, end_ns, name) on time.perf_counter_ns; and a flat
    dict of counters."""

    def __init__(self, intervals: bool = False):
        self.calls = {}
        self.total_ns = {}
        self.self_ns = {}
        self.counters = {}
        self.intervals = [] if intervals else None
        self._open = []     # time of the spans closed inside each open one


class _Span:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._open.append(0)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec, name = self.rec, self.name
        dt = t1 - self.t0
        inner = rec._open.pop()
        if rec._open:
            rec._open[-1] += dt
        rec.calls[name] = rec.calls.get(name, 0) + 1
        rec.total_ns[name] = rec.total_ns.get(name, 0) + dt
        rec.self_ns[name] = rec.self_ns.get(name, 0) + dt - inner
        if rec.intervals is not None:
            rec.intervals.append((self.t0, t1, name))
        return False


def span(name: str):
    """A context that times its body under name in the installed
    Recorder; the shared no-op context where none is installed."""
    rec = _RECORDER.get()
    if rec is None:
        return NO_SPAN
    return _Span(rec, name)


def traced(name: str):
    """Decorator: each call of the function is a span named name."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = _RECORDER.get()
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def count(name: str, n: int = 1) -> None:
    """Add n to the counter name of the installed Recorder and of each
    dict routed by counting()."""
    for d in _COUNTS.get():
        d[name] = d.get(name, 0) + n


def counting_on() -> bool:
    """Whether count() reaches anything: callers skip the work of a
    count (a tally over a batch's rows) where it does not."""
    return bool(_COUNTS.get())


@contextlib.contextmanager
def _installed(rec, counts):
    t_rec = _RECORDER.set(rec)
    t_counts = _COUNTS.set(_COUNTS.get() + (counts,))
    try:
        yield rec
    finally:
        _COUNTS.reset(t_counts)
        _RECORDER.reset(t_rec)


def recording(rec: Recorder):
    """Install rec for the length of the `with`: it receives every span
    and count in this thread (spans of an outer Recorder pause)."""
    return _installed(rec, rec.counters)


def counting(d: dict | None):
    """Route count() into d as well for the length of the `with` (the
    installed Recorder, if any, still receives its spans and counts);
    d None, or d already routed: nothing changes."""
    if d is None or any(c is d for c in _COUNTS.get()):
        return contextlib.nullcontext()
    return _installed(_RECORDER.get(), d)
