"""Zero-dependency tracing & metrics for the decode pipeline: port of
``repro.obs`` (pure Python, copied; the exports are byte-equal).

Where a window's latency goes — queue wait vs batch pack vs kernel
launch vs retire — and what the planner/plan-cache actually decided, as
(1) nestable spans with structured attributes (``tracer``), (2) fixed-
bucket latency/size histograms (``hist``), and (3) exportable artifacts:
Chrome trace-event JSON for Perfetto and a Prometheus text exposition
(``export``).

Enable for a whole process with one call (everything that resolved
``trace=None`` through :func:`get_tracer` lights up)::

    from repro_torch.obs import Tracer, set_tracer, write_chrome_trace
    tracer = Tracer()
    set_tracer(tracer)
    ... run the server / stream ...
    write_chrome_trace(tracer, "trace.json")   # open in Perfetto

or pass ``trace=tracer`` to ``DecodeServer`` / ``StreamDecoder``
explicitly. Disabled (the default) the whole layer is a shared no-op
object — nothing allocates on the hot path.

``ProfiledTracer`` (``profiled``) also puts each sync span into a running
``torch.profiler`` trace, on the clock of the device events; the decode
path's spans (``decode.*``, ``shard.*``) resolve through ``span_tracer``,
which lands them in a running profiler's trace even with no tracer set.
"""
from .tracer import (Tracer, NullTracer, NULL_TRACER,      # noqa: F401
                     SpanRecord, get_tracer, set_tracer)
from .hist import (Histogram, geometric_bounds,            # noqa: F401
                   LATENCY_MS_BOUNDS, SIZE_BOUNDS)
from .export import (chrome_trace, write_chrome_trace,     # noqa: F401
                     prometheus_text, write_metrics_json)
from .profiled import ProfiledTracer, span_tracer          # noqa: F401

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "SpanRecord",
           "get_tracer", "set_tracer", "Histogram", "geometric_bounds",
           "LATENCY_MS_BOUNDS", "SIZE_BOUNDS", "chrome_trace",
           "write_chrome_trace", "prometheus_text", "write_metrics_json",
           "ProfiledTracer", "span_tracer"]
