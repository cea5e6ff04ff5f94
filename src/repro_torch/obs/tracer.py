"""Nestable spans + counters: the zero-dependency tracing core (port of
``repro.obs.tracer``, pure Python, copied).

A ``Tracer`` records *spans* — named intervals with monotonic start time,
duration, and structured attributes — into a bounded, thread-safe ring
buffer. Three span flavors map onto the three shapes of work in the
decode pipeline:

  * ``span(name, **attrs)`` — a context manager for synchronous work
    (a push, a batched launch, a retire). Spans nest: the record carries
    its enclosing span's name, tracked per thread, so an exported trace
    shows ``launch_attempt`` inside ``launch`` inside a serve step.
  * ``begin(name, **attrs)`` / ``handle.end(**attrs)`` — an *async* span
    for work that overlaps other work (a dispatched chunk in flight
    behind the double-buffer front). Async spans may overlap freely;
    the Chrome exporter emits them as b/e pairs so Perfetto draws the
    overlap instead of faking a nesting.
  * ``event(name, **attrs)`` — an instant (a retry, a trace-time kernel
    specialization).

``count(name, n)`` bumps a named counter (plan-cache hits, kernel
traces); counters ride along in the exported trace metadata.

The pay-nothing contract (same as ``faults=`` in the serve layer): the
process-global tracer defaults to ``NULL_TRACER``, whose ``span``/
``begin`` return one shared no-op object and whose ``event``/``count``
are empty methods — no allocation, no lock, no branch beyond the call
itself. Components resolve ``trace=None`` to ``get_tracer()`` at
construction, so enabling observability is one ``set_tracer(Tracer())``
call and disabling it costs nothing on the hot path.

Storage is a ``deque(maxlen=capacity)`` ring: a long-running server keeps
O(capacity) memory and the trace describes recent traffic, exactly like
the serve metrics' rolling latency window.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

__all__ = ["SpanRecord", "Tracer", "NullTracer", "NULL_TRACER",
           "get_tracer", "set_tracer"]

#: Completed spans retained (ring buffer) by default.
DEFAULT_CAPACITY = 65536


class SpanRecord:
    """One completed span (or instant event). ``ts``/``dur`` are
    ``time.perf_counter`` seconds; the exporter rebases onto the tracer's
    epoch. ``kind`` is 'span' (sync, nests via ``parent``), 'async'
    (overlapping, pairs via ``sid``), or 'instant'."""
    __slots__ = ("name", "ts", "dur", "tid", "parent", "attrs", "kind",
                 "sid")

    def __init__(self, name, ts, dur, tid, parent, attrs, kind, sid=0):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.parent = parent
        self.attrs = attrs
        self.kind = kind
        self.sid = sid

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, dur={self.dur * 1e3:.3f}ms, "
                f"kind={self.kind}, parent={self.parent!r})")


class _Span:
    """Sync span context manager (one per ``Tracer.span`` call)."""
    __slots__ = ("_tr", "name", "attrs", "_t0", "_parent")

    def __init__(self, tracer, name, attrs):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. the plan a planner chose)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tr._stack()
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tr._record(SpanRecord(
            self.name, self._t0, t1 - self._t0, threading.get_ident(),
            self._parent, self.attrs, "span"))
        return False


class _AsyncSpan:
    """Handle returned by ``Tracer.begin``; call ``end()`` when the
    overlapped work materializes. Safe to end at most once."""
    __slots__ = ("_tr", "name", "attrs", "_t0", "_sid", "_done")

    def __init__(self, tracer, name, attrs, sid):
        self._tr = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._sid = sid
        self._done = False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self, **attrs):
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        t1 = time.perf_counter()
        self._tr._record(SpanRecord(
            self.name, self._t0, t1 - self._t0, threading.get_ident(),
            None, self.attrs, "async", self._sid))


class Tracer:
    """Thread-safe span/counter recorder with ring-buffer storage."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        assert capacity > 0
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counters = collections.Counter()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self.t0 = time.perf_counter()           # export epoch

    # -- recording --------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)

    def span(self, name: str, **attrs) -> _Span:
        """Context manager: records a sync span on exit, nested under the
        thread's currently-open span."""
        return _Span(self, name, attrs)

    def begin(self, name: str, **attrs) -> _AsyncSpan:
        """Open an async (overlapping) span; ``.end()`` completes it."""
        return _AsyncSpan(self, name, attrs, next(self._ids))

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (zero duration)."""
        t = time.perf_counter()
        stack = self._stack()
        self._record(SpanRecord(name, t, 0.0, threading.get_ident(),
                                stack[-1].name if stack else None, attrs,
                                "instant"))

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named counter."""
        with self._lock:
            self._counters[name] += n

    # -- introspection ----------------------------------------------------
    def spans(self) -> list:
        """Snapshot of the retained span records (oldest first)."""
        with self._lock:
            return list(self._spans)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()


class _NullSpan:
    """The shared no-op span/handle: enter/exit/set/end all do nothing.
    One instance serves every disabled call site — the disabled hot path
    allocates nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every hook is a no-op returning shared objects."""

    enabled = False
    t0 = 0.0

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def begin(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **attrs) -> None:
        return None

    def count(self, name: str, n: int = 1) -> None:
        return None

    def spans(self) -> list:
        return []

    def counters(self) -> dict:
        return {}

    def clear(self) -> None:
        return None


#: The shared disabled tracer (the ``trace=None`` resolution target).
NULL_TRACER = NullTracer()

_global_tracer = NULL_TRACER
_global_lock = threading.Lock()


def get_tracer():
    """The process-global tracer (``NULL_TRACER`` unless one was set).
    Components resolve ``trace=None`` through this at construction, and
    trace-time hooks (kernel wrapper, planner, plan cache) consult it
    directly — one ``set_tracer`` lights up the whole pipeline."""
    return _global_tracer


def set_tracer(tracer):
    """Install ``tracer`` as the process-global tracer (``None`` restores
    ``NULL_TRACER``). Returns the previous tracer so callers can scope an
    enablement and restore it."""
    global _global_tracer
    with _global_lock:
        prev = _global_tracer
        _global_tracer = tracer if tracer is not None else NULL_TRACER
        return prev
