"""The port's observability layer (repro_torch.obs) against the JAX
package's, on the CPU.

Mirrors the part of tests/test_obs.py that does not run JAX: span nesting
and attributes, the pay-nothing disabled tracer, histogram percentiles
against np.percentile, the Chrome trace-event schema and the Prometheus
exposition, and the instrumentation of the port's serve and stream paths.
The modules are copied pure Python: for the same records the Chrome
trace and the Prometheus text are byte-equal to the JAX package's, and
the same samples give the same histogram state.
"""
import json
import re
import threading

import numpy as np
import pytest

from _torch_parity import rx
from repro.obs import export as jexport
from repro.obs import hist as jhist
from repro.obs import tracer as jtracer

from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig
from repro_torch.core.stream import make_stream_decoder
from repro_torch.obs import (Histogram, NULL_TRACER, Tracer, chrome_trace,
                             geometric_bounds, get_tracer, prometheus_text,
                             set_tracer, write_chrome_trace,
                             write_metrics_json)
from repro_torch.obs import export as texport
from repro_torch.obs import hist as thist
from repro_torch.obs import tracer as ttracer
from repro_torch.obs.tracer import NullTracer
from repro_torch.serve import DecodeServer, PlanCache
from repro_torch.testing import FaultInjector, FaultSpec

SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)


@pytest.fixture(autouse=True)
def _restore_global_tracer():
    yield
    set_tracer(None)


# ---------------------------------------------------------------- tracer
def test_span_nesting_parent_and_attrs():
    t = Tracer()
    with t.span("outer", a=1):
        with t.span("inner") as sp:
            sp.set(b="two")
    recs = {r.name: r for r in t.spans()}
    assert recs["inner"].parent == "outer" and recs["outer"].parent is None
    assert recs["inner"].attrs == {"b": "two"}
    assert recs["outer"].attrs == {"a": 1}
    assert recs["outer"].dur >= recs["inner"].dur >= 0.0
    assert [r.name for r in t.spans()] == ["inner", "outer"]


def test_span_records_error_attr_on_exception():
    t = Tracer()
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    (rec,) = t.spans()
    assert rec.attrs["error"] == "RuntimeError"


def test_async_spans_overlap_and_end_is_idempotent():
    t = Tracer()
    a = t.begin("chunk", i=0)
    b = t.begin("chunk", i=1)
    b.end(bits=64)
    a.end()
    a.end()
    recs = t.spans()
    assert len(recs) == 2 and all(r.kind == "async" for r in recs)
    assert recs[0].sid != recs[1].sid
    assert recs[0].attrs == {"i": 1, "bits": 64}


def test_events_counters_and_ring_buffer():
    t = Tracer(capacity=8)
    with t.span("launch"):
        t.event("retry", attempt=1)
    t.count("hits")
    t.count("hits", 2)
    (ev, sp) = t.spans()
    assert (ev.kind, ev.dur, ev.parent) == ("instant", 0.0, "launch")
    assert t.counters() == {"hits": 3}
    t.clear()
    for i in range(20):
        with t.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in t.spans()] == list(range(12, 20))


def test_tracer_is_thread_safe():
    t = Tracer()

    def work(k):
        for _ in range(200):
            with t.span("w", k=k):
                t.count("n")

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.counters()["n"] == 800 and len(t.spans()) == 800
    assert all(r.parent is None for r in t.spans())


def test_null_tracer_pays_nothing_and_registry():
    n = NullTracer()
    assert n.span("a") is n.span("b") is n.begin("a")
    with n.span("a") as sp:
        sp.set(x=1)
    n.begin("c").end()
    n.event("e")
    n.count("k")
    assert n.spans() == [] and n.counters() == {} and not n.enabled
    assert get_tracer() is NULL_TRACER
    t = Tracer()
    assert set_tracer(t) is NULL_TRACER and get_tracer() is t
    assert set_tracer(None) is t and get_tracer() is NULL_TRACER


def test_tracer_api_is_the_jax_packages():
    for name in ("Tracer", "NullTracer", "SpanRecord"):
        mine = {m for m in dir(getattr(ttracer, name))
                if not m.startswith("__")}
        theirs = {m for m in dir(getattr(jtracer, name))
                  if not m.startswith("__")}
        assert mine == theirs, name
    assert ttracer.DEFAULT_CAPACITY == jtracer.DEFAULT_CAPACITY


# ------------------------------------------------------------- histogram
def test_histogram_percentiles_track_np_percentile():
    samples = np.exp(np.random.default_rng(0).normal(1.0, 1.2, size=5000))
    h = Histogram.latency_ms()
    h.extend(samples)
    for p in (50, 90, 99):
        exact = float(np.percentile(samples, p))
        assert abs(h.percentile(p) - exact) / exact < 0.25, p
    assert h.count == 5000
    assert abs(h.mean() - samples.mean()) / samples.mean() < 1e-6


def test_histogram_state_equals_jax():
    samples = np.exp(np.random.default_rng(1).normal(0.0, 2.0, size=777))
    mine, theirs = thist.Histogram.latency_ms(), jhist.Histogram.latency_ms()
    for h in (mine, theirs):
        h.extend(samples)
    assert mine.state_dict() == theirs.state_dict()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.cumulative() == theirs.cumulative()
    assert thist.LATENCY_MS_BOUNDS == jhist.LATENCY_MS_BOUNDS
    assert thist.SIZE_BOUNDS == jhist.SIZE_BOUNDS
    back = thist.Histogram.latency_ms().load_state(theirs.state_dict())
    assert back.state_dict() == theirs.state_dict()


def test_histogram_degenerate_empty_merge_and_bounds():
    h = Histogram.latency_ms()
    assert h.percentile(99) == 0.0 and h.mean() == 0.0
    h.extend([3.7] * 100)
    assert h.percentile(50) == pytest.approx(3.7)
    assert h.snapshot()["max"] == pytest.approx(3.7)
    with pytest.raises(ValueError):
        h.merge(Histogram.sizes())
    b = geometric_bounds(1.0, 100.0, 2.0)
    assert b[0] == 1.0 and b[-1] >= 100.0


# ------------------------------------------------------------- exporters
class _Records:
    """Fixed records (timestamps included) for both packages' exporters."""
    t0 = 100.0

    def __init__(self, mod):
        R = mod.SpanRecord
        self._spans = [
            R("batch_pack", 100.5, 0.001, 11, "launch", {"bucket": "b0"},
              "span"),
            R("retry", 100.6, 0.0, 11, "launch", {"attempt": 1}, "instant"),
            R("launch", 100.4, 0.25, 11, None,
              {"bucket": "b0", "shape": (4, 2)}, "span"),
            R("inflight", 100.7, 0.5, 22, None, {"frames": 8}, "async", 7),
        ]

    def spans(self):
        return list(self._spans)

    def counters(self):
        return {"plan_cache_hits": 3, "kernel_traces": 1}


def test_chrome_trace_is_byte_equal_to_jax(tmp_path):
    mine = chrome_trace(_Records(ttracer))
    assert json.dumps(mine) == json.dumps(
        jexport.chrome_trace(_Records(jtracer)))
    ev = mine["traceEvents"]
    assert [e["ph"] for e in ev] == ["M", "X", "i", "X", "b", "e"]
    assert ev[1]["args"]["parent"] == "launch"
    assert ev[3]["args"]["shape"] == "(4, 2)"
    assert ev[4]["id"] == ev[5]["id"] == "7"
    path = tmp_path / "trace.json"
    write_chrome_trace(_Records(ttracer), str(path))
    assert json.loads(path.read_text()) == mine


_EXPO_LINE = re.compile(
    r'^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
    r'(,[a-zA-Z0-9_]+="[^"]*")*\})? -?[0-9.e+-]+)$')

_SNAP = {"totals": {"launches": 4, "mbps": 1.25, "health": "ok"},
         "sessions": 2,
         "buckets": [{"bucket": "K7-f64", "launches": 4, "p50_ms": 0.5,
                      "last_error": "boom \"q\""}],
         "stages": {"launch_ms": {"count": 4, "p50": 0.4, "p99": 0.9,
                                  "max": 1.0, "mean": 0.5, "total": 2.0}},
         "stages_hist": {"queue_wait_ms": {"buckets": [[0.5, 2], [2.0, 5],
                                                       ["+Inf", 7]],
                                           "sum": 6.25, "count": 7}},
         "plan_cache": {"entries": 2, "hits": 5, "misses": 2, "traces": 2,
                        "build_ms": 1.5}}


def test_prometheus_text_is_byte_equal_to_jax_and_parses():
    text = prometheus_text(_SNAP)
    assert text == jexport.prometheus_text(_SNAP)
    lines = text.strip().split("\n")
    for line in lines:
        assert _EXPO_LINE.match(line), f"unparseable line: {line!r}"
    assert "# TYPE repro_serve_launches counter" in lines
    assert "repro_serve_mbps 1.25" in lines
    assert lines.count("# TYPE repro_serve_stage_ms histogram") == 1
    assert ('repro_serve_stage_ms_bucket{le="+Inf",stage="queue_wait_ms"} 7'
            in lines)
    assert "health" not in text and "boom" not in text


def test_metrics_json_is_byte_equal_to_jax(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    write_metrics_json(_SNAP, str(a))
    jexport.write_metrics_json(_SNAP, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert texport._COUNTER_KEYS == jexport._COUNTER_KEYS


# -------------------------------------------------- pipeline integration
def _serve_workload(trace, faults=None, **kw):
    srv = DecodeServer(slots=2, cache=PlanCache(), trace=trace,
                       faults=faults, device="cpu", **kw)
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    n = 2 * 5 * SPEC.f
    data = rx(n, seed=0)
    sids = [srv.open_session(cfg, chunk_frames=5) for _ in range(2)]
    for r in range(2):
        for sid in sids:
            srv.push(sid, data[r * (n // 2):(r + 1) * (n // 2)])
        while srv.step():
            pass
    return srv, sids


def test_server_spans_nest_and_stage_breakdown_lands_in_snapshot():
    t = Tracer()
    srv, sids = _serve_workload(t)
    for sid in sids:
        srv.close_session(sid)
    by_name = {}
    for r in t.spans():
        by_name.setdefault(r.name, []).append(r)
    assert {"push", "launch", "batch_pack", "launch_attempt", "retire",
            "inflight"} <= set(by_name)
    assert all(r.parent == "launch" for r in by_name["batch_pack"])
    assert all(r.parent == "launch" for r in by_name["launch_attempt"])
    assert all(r.kind == "async" for r in by_name["inflight"])
    snap = srv.metrics_snapshot()
    for stage in ("queue_wait_ms", "batch_pack_ms", "launch_ms",
                  "retire_ms"):
        assert snap["stages"][stage]["count"] > 0, stage
    assert snap["totals"]["mbps"] > 0 and snap["totals"]["uptime_s"] > 0
    json.dumps(snap)
    text = prometheus_text(snap)
    for line in text.strip().split("\n"):
        assert _EXPO_LINE.match(line), f"unparseable line: {line!r}"
    json.dumps(chrome_trace(t))


def test_server_retry_and_degrade_spans_under_faults():
    t = Tracer()
    faults = FaultInjector(FaultSpec("launch_error", every=1), seed=0)
    srv, sids = _serve_workload(t, faults=faults, max_retries=1,
                                backoff_s=0.0)
    for sid in sids:
        srv.close_session(sid)
    names = {r.name for r in t.spans()}
    assert "retry" in names and "degrade" in names
    assert any("error" in r.attrs for r in t.spans()
               if r.name == "launch_attempt")


def test_stream_decoder_emits_async_chunk_spans():
    t = Tracer()
    dec = make_stream_decoder(DecoderConfig(spec=SPEC), chunk_frames=4,
                              trace=t, device="cpu")
    n = 3 * 4 * SPEC.f
    out = np.concatenate([dec.push(rx(n, seed=1)), dec.flush()])
    assert out.size == n
    chunks = [r for r in t.spans() if r.name == "chunk"]
    assert len(chunks) == 3 and all(r.kind == "async" for r in chunks)
    assert {r.name for r in t.spans()} >= {"push", "flush", "dispatch"}


def test_plan_cache_counts_hits_misses_and_build_time():
    t = Tracer()
    set_tracer(t)
    cache = PlanCache()
    cfg = DecoderConfig(spec=SPEC)
    cache.frame_decoder(cfg, device="cpu")
    cache.frame_decoder(cfg, device="cpu")
    c = t.counters()
    assert c["plan_cache_misses"] == 1 and c["plan_cache_hits"] == 1
    assert any(r.name == "plan_build" for r in t.spans())
    assert cache.stats()["build_ms"] >= 0.0


def test_record_fault_rejects_unknown_counter():
    from repro_torch.serve.metrics import FAULT_COUNTERS, BucketMetrics
    from repro.serve.metrics import FAULT_COUNTERS as JFAULT_COUNTERS
    assert FAULT_COUNTERS == JFAULT_COUNTERS
    m = BucketMetrics("b0")
    with pytest.raises(ValueError, match="unknown fault counter"):
        m.record_fault("not_a_counter")
    m.record_fault("retries", error="e1", n=2)
    assert m.retries == 2 and m.last_error == "e1"
