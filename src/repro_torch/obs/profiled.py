"""Spans on ``torch.profiler``'s clock.

``tracer.Tracer`` times its spans with ``time.perf_counter``, a clock no
device event is on. ``ProfiledTracer`` is a ``Tracer`` whose sync spans
also open a ``torch.profiler.record_function`` range of the same name, so
each span lands in the profiler's trace beside the operators it runs and
the device work they launch (CUPTI's events, on the profiler's clock);
the ring gets the same records as ``Tracer``'s. Async spans, instants and
counters are ``Tracer``'s.

The decode path resolves its tracer through :func:`span_tracer` at each
call. With no tracer set (``NULL_TRACER``) it is ``NULL_TRACER``, and
every hook is the shared no-op; only while a ``torch.profiler`` records
does it return ``PROFILER_SPANS``, whose sync spans are the profiler
ranges alone, so a profiled run names the decode path's parts without a
tracer of its own. ``set_tracer(NullTracer())`` keeps them out of the
profiler too.
"""
from __future__ import annotations

import torch.autograd.profiler as _profiler

from .tracer import NULL_TRACER, NullTracer, Tracer, _Span, get_tracer

__all__ = ["ProfiledTracer", "ProfilerSpans", "PROFILER_SPANS",
           "span_tracer"]


class _ProfiledSpan(_Span):
    """A ring span inside a profiler range of the same name."""
    __slots__ = ("_range",)

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        super().__exit__(exc_type, exc, tb)
        self._range.__exit__(exc_type, exc, tb)
        return False


class ProfiledTracer(Tracer):
    """A ``Tracer`` whose sync spans are also ``torch.profiler`` ranges."""

    def span(self, name: str, **attrs) -> _ProfiledSpan:
        return _ProfiledSpan(self, name, attrs)


class _ProfilerRange:
    """A profiler range with the span interface (``set``/``end`` do
    nothing: the range keeps only its name)."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return None


class ProfilerSpans(NullTracer):
    """Records nothing: its sync spans are profiler ranges alone."""

    def span(self, name: str, **attrs) -> _ProfilerRange:
        return _ProfilerRange(name)


#: The tracer of the decode path's spans while a profiler records and no
#: tracer is set.
PROFILER_SPANS = ProfilerSpans()


def span_tracer():
    """``get_tracer()``, or ``PROFILER_SPANS`` while a ``torch.profiler``
    records and the global tracer is ``NULL_TRACER``."""
    tracer = get_tracer()
    if tracer is NULL_TRACER and _profiler._is_profiler_enabled:
        return PROFILER_SPANS
    return tracer
