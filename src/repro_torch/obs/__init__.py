"""Tracing for the port's decode path (events and counters; see tracer)."""
from .tracer import (Tracer, NullTracer, NULL_TRACER,      # noqa: F401
                     SpanRecord, get_tracer, set_tracer)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "SpanRecord",
           "get_tracer", "set_tracer"]
