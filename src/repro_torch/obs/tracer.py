"""Spans, instant events and counters: the part of ``repro.obs.tracer``
that the port's decode path and planner record (port, pure Python).

``span(name, **attrs)`` is a context manager that records a timed span
(``plan_decode`` puts the plan it chose on its span with ``set``);
``event(name, **attrs)`` records an instant into a bounded, thread-safe
ring; ``count(name, n)`` bumps a named counter. The process-global tracer
defaults to ``NULL_TRACER``, whose hooks are empty methods, so a disabled
tracer costs one call. Async spans come with the stream and serve layers,
in a later slice of the port.
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["SpanRecord", "Tracer", "NullTracer", "NULL_TRACER",
           "get_tracer", "set_tracer"]

#: Records retained (ring buffer) by default.
DEFAULT_CAPACITY = 65536


class SpanRecord:
    """One recorded instant. ``ts`` is ``time.perf_counter`` seconds; same
    fields as the JAX package's record so the exporters carry over."""
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
        return f"SpanRecord({self.name!r}, kind={self.kind})"


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
        rec = SpanRecord(self.name, self._t0, t1 - self._t0,
                         threading.get_ident(), self._parent, self.attrs,
                         "span")
        with self._tr._lock:
            self._tr._spans.append(rec)
        return False


class _NullSpan:
    """What a disabled tracer's ``span`` returns: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span/event/counter recorder with ring-buffer storage."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counters = collections.Counter()
        self._tls = threading.local()
        self.t0 = time.perf_counter()           # export epoch

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> _Span:
        """Context manager recording a timed span on exit."""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (zero duration)."""
        rec = SpanRecord(name, time.perf_counter(), 0.0,
                         threading.get_ident(), None, attrs, "instant")
        with self._lock:
            self._spans.append(rec)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named counter."""
        with self._lock:
            self._counters[name] += n

    def spans(self) -> list:
        """Snapshot of the retained records (oldest first)."""
        with self._lock:
            return list(self._spans)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()


class NullTracer:
    """Disabled tracer: every hook is a no-op."""

    enabled = False
    t0 = 0.0

    def span(self, name: str, **attrs) -> _NullSpan:
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


#: The shared disabled tracer.
NULL_TRACER = NullTracer()

_global_tracer = NULL_TRACER
_global_lock = threading.Lock()


def get_tracer():
    """The process-global tracer (``NULL_TRACER`` unless one was set)."""
    return _global_tracer


def set_tracer(tracer):
    """Install ``tracer`` as the process-global tracer (``None`` restores
    ``NULL_TRACER``). Returns the previous tracer."""
    global _global_tracer
    with _global_lock:
        prev = _global_tracer
        _global_tracer = tracer if tracer is not None else NULL_TRACER
        return prev
