"""Exporters: Chrome ``trace_event`` JSON and metrics expositions (port of
``repro.obs.export``, pure Python, copied: for the same records the
output is byte-equal to the JAX package's).

Two consumers, two formats:

  * ``chrome_trace`` / ``write_chrome_trace`` — the tracer's span ring as
    a Chrome trace-event JSON object, loadable in Perfetto or
    chrome://tracing. Sync spans become complete ('X') events nested by
    thread, async spans (double-buffered chunks/launches in flight)
    become b/e pairs so their overlap renders as overlap, instants
    become 'i' events, and the tracer's counters ride in ``otherData``.
  * ``prometheus_text`` — a ``DecodeServer.metrics_snapshot()`` dict as
    Prometheus text exposition (``# TYPE`` lines + ``name{labels} value``
    samples), scrapable as-is; ``write_metrics_json`` is the same
    snapshot as a JSON file for offline diffing.

Pure stdlib; nothing here imports the decode stack, so the obs layer
stays dependency-free in both directions.
"""
from __future__ import annotations

import json
import re

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text",
           "write_metrics_json"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: Snapshot fields exposed as monotone counters (everything else is a
#: gauge). Mirrors serve.metrics.FAULT_COUNTERS plus the volume fields —
#: kept local so obs never imports the decode stack.
_COUNTER_KEYS = frozenset({
    "launches", "windows", "frames", "pad_frames", "bits",
    "launch_errors", "timeouts", "retries", "degraded", "cache_refreshes",
    "poisoned_pushes", "sanitized_values", "quarantined",
    "entries", "hits", "misses", "traces"})


def _jsonable(v):
    """Attribute values must survive json.dump: pass scalars through,
    stringify everything else (enums, tuples, arrays)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def chrome_trace(tracer) -> dict:
    """The tracer's retained spans as a Chrome trace-event object.

    Timestamps are microseconds since the tracer's epoch (``tracer.t0``),
    everything on one pid with one tid per recording thread.
    """
    events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "repro-viterbi-decode"}}]
    tids: dict = {}
    epoch = getattr(tracer, "t0", 0.0)
    for rec in tracer.spans():
        tid = tids.setdefault(rec.tid, len(tids))
        ts = (rec.ts - epoch) * 1e6
        args = {k: _jsonable(v) for k, v in rec.attrs.items()}
        if rec.parent is not None:
            args.setdefault("parent", rec.parent)
        base = {"name": rec.name, "cat": "decode", "pid": 0, "tid": tid,
                "args": args}
        if rec.kind == "span":
            events.append({**base, "ph": "X", "ts": round(ts, 3),
                           "dur": round(rec.dur * 1e6, 3)})
        elif rec.kind == "instant":
            events.append({**base, "ph": "i", "ts": round(ts, 3), "s": "t"})
        else:                                   # async: overlap as b/e pair
            ident = str(rec.sid)
            events.append({**base, "cat": "async", "ph": "b",
                           "id": ident, "ts": round(ts, 3)})
            events.append({"name": rec.name, "cat": "async", "ph": "e",
                           "id": ident, "pid": 0, "tid": tid, "args": {},
                           "ts": round(ts + rec.dur * 1e6, 3)})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": tracer.counters()}}


def write_chrome_trace(tracer, path: str) -> dict:
    """Dump ``chrome_trace(tracer)`` to ``path``; returns the object."""
    obj = chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(obj, fh)
        fh.write("\n")
    return obj


def _metric_name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(p for p in parts if p))


def _label(value) -> str:
    return str(value).replace("\\", r"\\").replace('"', r'\"')


def _labelstr(labels: dict | None) -> str:
    if not labels:
        return ""
    return ("{" + ",".join(f'{k}="{_label(v)}"'
                           for k, v in sorted(labels.items())) + "}")


class _Expo:
    """Accumulates exposition lines with one # TYPE header per metric."""

    def __init__(self):
        self.lines: list[str] = []
        self._typed: set[str] = set()

    def sample(self, name: str, value, labels: dict | None = None,
               mtype: str = "gauge"):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            return
        if name not in self._typed:
            self._typed.add(name)
            self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.append(f"{name}{_labelstr(labels)} {value}")

    def histogram(self, name: str, buckets, total, count,
                  labels: dict | None = None):
        """One Prometheus histogram: ``# TYPE name histogram`` once, then
        ``name_bucket{le=...}`` samples (cumulative, ending at +Inf) plus
        ``name_sum``/``name_count`` — the convention every Prometheus
        aggregator understands (histogram_quantile works on these)."""
        if name not in self._typed:
            self._typed.add(name)
            self.lines.append(f"# TYPE {name} histogram")
        labels = labels or {}
        for le, c in buckets:
            self.lines.append(
                f"{name}_bucket{_labelstr({**labels, 'le': le})} {c}")
        self.lines.append(f"{name}_sum{_labelstr(labels)} {total}")
        self.lines.append(f"{name}_count{_labelstr(labels)} {count}")


def prometheus_text(snapshot: dict, prefix: str = "repro_serve") -> str:
    """A ``metrics_snapshot()`` dict as Prometheus text exposition.

    Emits totals (counters + gauges), per-bucket rows with a
    ``bucket=...`` label, stage-latency summaries with ``stage=...`` and
    ``stat=...`` labels, the server-wide stage histograms as true
    Prometheus histogram series (``{prefix}_stage_ms_bucket{stage=,le=}``
    cumulative samples + ``_sum``/``_count``, from the snapshot's
    ``stages_hist`` key), and the plan-cache counters
    (entries/hits/misses/traces/build_ms). Non-numeric fields (health
    strings, error messages) are skipped — expositions carry numbers
    only; the histogram ``le`` bound rides in a label so the ``+Inf``
    bucket stays exposition-legal.
    """
    expo = _Expo()
    for key, val in sorted(snapshot.get("totals", {}).items()):
        mtype = "counter" if key in _COUNTER_KEYS else "gauge"
        expo.sample(_metric_name(prefix, key), val, mtype=mtype)
    for scalar in ("sessions", "quarantined_sessions"):
        if scalar in snapshot:
            expo.sample(_metric_name(prefix, scalar), snapshot[scalar])
    for row in snapshot.get("buckets", []):
        labels = {"bucket": row.get("bucket", "?")}
        for key, val in sorted(row.items()):
            if key == "bucket":
                continue
            mtype = "counter" if key in _COUNTER_KEYS else "gauge"
            expo.sample(_metric_name(prefix, "bucket", key), val, labels,
                        mtype)
    for stage, summ in sorted(snapshot.get("stages", {}).items()):
        name = _metric_name(prefix, "stage", "latency_ms")
        for stat, val in sorted(summ.items()):
            expo.sample(name, val, {"stage": stage, "stat": stat})
    # full-resolution stage histograms (snapshot "stages_hist"): real
    # Prometheus histogram series — unlike the p50/p99 gauges above these
    # aggregate across servers, so a fleet dashboard can compute honest
    # fleet-wide quantiles with histogram_quantile()
    for stage, hist in sorted(snapshot.get("stages_hist", {}).items()):
        expo.histogram(_metric_name(prefix, "stage", "ms"),
                       hist.get("buckets", ()), hist.get("sum", 0),
                       hist.get("count", 0), {"stage": stage})
    for key, val in sorted(snapshot.get("plan_cache", {}).items()):
        mtype = "counter" if key in _COUNTER_KEYS else "gauge"
        expo.sample(_metric_name(prefix, "plan_cache", key), val,
                    mtype=mtype)
    return "\n".join(expo.lines) + "\n"


def write_metrics_json(snapshot: dict, path: str) -> None:
    """The snapshot as pretty JSON (the offline twin of the exposition)."""
    with open(path, "w") as fh:
        json.dump(snapshot, fh, indent=1, sort_keys=True, default=str)
        fh.write("\n")
