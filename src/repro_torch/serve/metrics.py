"""Per-bucket serving metrics: latency percentiles, batch occupancy,
derived throughput, stage-latency breakdowns, and fault-tolerance health
counters (port of ``repro.serve.metrics``, numpy, copied: the same
counters and snapshot keys).

The serve layer's whole reason to exist is batch occupancy — the kernels
only hit their throughput at high frame counts per launch — so the
metrics are organized around the launch: how many frames of each batched
launch carried live session data vs padding, and how long each window
waited between enqueue (push) and materialized bits. Latencies land in
fixed-bucket histograms (repro_torch.obs.hist): recording stays O(1) per
window, ``totals()`` aggregates by merging bucket histograms, and memory
is O(buckets) no matter how long the server lives. ``p50_ms``/``p99_ms``
are bucket-resolution percentiles (~19% geometric buckets, exact for
degenerate distributions).

Each bucket (and the server total) also derives throughput from a
monotonic epoch: ``uptime_s`` since the bucket/server first existed and
``mbps`` = decoded bits / uptime — so front-ends stop hand-computing
aggregate rates around their own loops.

``stage(name)`` returns the server-wide histogram for one pipeline stage
(queue_wait / batch_pack / launch / retire, in ms); the snapshot carries
their summaries as the stage-latency breakdown the tracing layer's spans
drill into.

Since the fault-tolerance layer, each bucket also tracks its failure
story: launch errors and deadline timeouts, retries, launches that
DEGRADED to the reference-decoder fallback, plan-cache refreshes forced
by fault injection, poisoned pushes (and how many values were
sanitized), and sessions quarantined out of the bucket. ``health`` folds
those into a one-word per-bucket status the snapshot carries:
``ok`` (no faults seen), ``impaired`` (faults seen, all recovered by
retry/sanitize), ``degraded`` (at least one launch fell back to the
reference decoder — results stay correct, the bucket is not running its
kernel fast path).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..obs.hist import Histogram

__all__ = ["BucketMetrics", "ServeMetrics", "percentile", "FAULT_COUNTERS",
           "STAGES"]

#: Counter fields summed into ``ServeMetrics.totals()`` and carried in
#: every snapshot row (the robustness-observability contract).
#: ``breaker_trips`` counts circuit-breaker open transitions (consecutive
#: launch failures exceeded the threshold — the device-failure signal);
#: ``evacuated`` counts sessions moved off a tripped bucket to its
#: failover bucket (pinned to the reference backend / healthy device).
FAULT_COUNTERS = ("launch_errors", "timeouts", "retries", "degraded",
                  "cache_refreshes", "poisoned_pushes", "sanitized_values",
                  "quarantined", "breaker_trips", "evacuated")

#: Pipeline stages with a server-wide latency histogram (all in ms; the
#: tracing spans of the same names carry the per-occurrence detail).
STAGES = ("queue_wait_ms", "batch_pack_ms", "launch_ms", "retire_ms")


def percentile(samples, p: float) -> float:
    """Exact p-th percentile of raw ``samples`` (0.0 when empty) — kept
    for tests/tools that hold their own sample lists; the serve rows
    themselves are histogram-backed now."""
    if not len(samples):
        return 0.0
    return float(np.percentile(np.asarray(samples, np.float64), p))


@dataclasses.dataclass
class BucketMetrics:
    """Counters for one session bucket (one plan)."""
    bucket: str                       # plan fingerprint / display id
    launches: int = 0
    windows: int = 0                  # live windows decoded
    frames: int = 0                   # live frames decoded
    pad_frames: int = 0               # padding frames launched
    bits: int = 0                     # real bits returned to sessions
    # -- fault-tolerance counters -----------------------------------------
    launch_errors: int = 0            # kernel launches that raised
    timeouts: int = 0                 # launches past the deadline
    retries: int = 0                  # re-dispatch attempts after a fault
    degraded: int = 0                 # launches served by the ref fallback
    cache_refreshes: int = 0          # forced plan-cache rebuilds
    poisoned_pushes: int = 0          # pushes failing input validation
    sanitized_values: int = 0         # LLR values scrubbed/clamped
    quarantined: int = 0              # sessions quarantined (cumulative)
    breaker_trips: int = 0            # circuit-breaker open transitions
    evacuated: int = 0                # sessions evacuated off this bucket
    last_error: str = ""              # most recent fault, human-readable
    latency: Histogram = dataclasses.field(
        default_factory=Histogram.latency_ms)
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    def record_launch(self, live_frames: int, pad_frames: int, windows: int,
                      bits: int, window_latency_ms) -> None:
        self.launches += 1
        self.frames += live_frames
        self.pad_frames += pad_frames
        self.windows += windows
        self.bits += bits
        self.latency.extend(float(t) for t in window_latency_ms)

    def record_fault(self, counter: str, error: str = "", n: int = 1) -> None:
        """Bump one fault counter (a FAULT_COUNTERS name); remember the
        most recent error string for the snapshot. An unknown counter
        name is a real ValueError — this is the fault-accounting contract
        and must not vanish under ``python -O`` the way an assert would."""
        if counter not in FAULT_COUNTERS:
            raise ValueError(
                f"unknown fault counter {counter!r}; expected one of "
                f"{FAULT_COUNTERS}")
        setattr(self, counter, getattr(self, counter) + n)
        if error:
            self.last_error = error

    @property
    def occupancy(self) -> float:
        """Live fraction of launched frames (1.0 = perfectly packed)."""
        total = self.frames + self.pad_frames
        return self.frames / total if total else 0.0

    @property
    def uptime_s(self) -> float:
        """Monotonic seconds since this bucket first saw a session."""
        return time.perf_counter() - self.t0

    @property
    def mbps(self) -> float:
        """Decoded Mb/s over the bucket's lifetime."""
        dt = self.uptime_s
        return self.bits / dt / 1e6 if dt > 0 else 0.0

    @property
    def health(self) -> str:
        """'ok' | 'impaired' (faults seen, all recovered on the fast
        path) | 'degraded' (reference fallback was needed, or the
        bucket's circuit breaker tripped and its sessions were
        evacuated)."""
        if self.degraded or self.breaker_trips:
            return "degraded"
        if (self.launch_errors or self.timeouts or self.retries
                or self.poisoned_pushes or self.quarantined):
            return "impaired"
        return "ok"

    def p50_ms(self) -> float:
        return self.latency.percentile(50)

    def p99_ms(self) -> float:
        return self.latency.percentile(99)

    def snapshot(self) -> dict:
        """JSON-ready row (the JAX package's serve row shape)."""
        row = {"bucket": self.bucket, "launches": self.launches,
               "windows": self.windows, "frames": self.frames,
               "pad_frames": self.pad_frames, "bits": self.bits,
               "occupancy": round(self.occupancy, 4),
               "p50_ms": round(self.p50_ms(), 3),
               "p99_ms": round(self.p99_ms(), 3),
               "mbps": round(self.mbps, 4),
               "uptime_s": round(self.uptime_s, 3),
               "health": self.health}
        row.update({c: getattr(self, c) for c in FAULT_COUNTERS})
        if self.last_error:
            row["last_error"] = self.last_error
        return row

    #: Plain counter fields round-tripped by the serve checkpoint.
    _STATE_FIELDS = ("launches", "windows", "frames", "pad_frames",
                     "bits") + FAULT_COUNTERS

    def state_dict(self) -> dict:
        """JSON-ready full state for the serve checkpoint — counters,
        the latency histogram, and the uptime accumulated so far (the
        monotonic epoch itself cannot cross processes)."""
        state = {f: getattr(self, f) for f in self._STATE_FIELDS}
        state["last_error"] = self.last_error
        state["uptime_s"] = self.uptime_s
        state["latency"] = self.latency.state_dict()
        return state

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict``; uptime continues from the saved
        value (a restored server reports cumulative uptime, not a fresh
        epoch — the crash-recovery CI stage gates this)."""
        for f in self._STATE_FIELDS:
            setattr(self, f, int(state[f]))
        self.last_error = str(state["last_error"])
        self.t0 = time.perf_counter() - float(state["uptime_s"])
        self.latency.load_state(state["latency"])


class ServeMetrics:
    """All buckets of one DecodeServer, plus the server-wide stage
    histograms and the throughput epoch."""

    def __init__(self):
        self._buckets: dict[str, BucketMetrics] = {}
        self._stages: dict[str, Histogram] = {}
        self.t0 = time.perf_counter()

    def bucket(self, bucket_id: str) -> BucketMetrics:
        m = self._buckets.get(bucket_id)
        if m is None:
            m = self._buckets[bucket_id] = BucketMetrics(bucket_id)
        return m

    def stage(self, name: str) -> Histogram:
        """The server-wide latency histogram for one pipeline stage."""
        h = self._stages.get(name)
        if h is None:
            h = self._stages[name] = Histogram.latency_ms()
        return h

    def stage_snapshot(self) -> dict:
        """{stage: summary} — the stage-latency breakdown rows."""
        return {name: h.snapshot() for name, h in self._stages.items()}

    def stage_histograms(self) -> dict:
        """{stage: {buckets, sum, count}} — the FULL stage histograms in
        Prometheus histogram shape: ``buckets`` is ``[le, cumulative]``
        pairs including the terminal ``+Inf`` bucket (a string, so the
        snapshot stays strict JSON). ``stage_snapshot`` carries the
        summary stats; this carries the distribution a scrape can
        aggregate across servers (export.prometheus_text emits it as
        ``_bucket``/``_sum``/``_count`` sample lines)."""
        def shape(h):
            return {"buckets": [["+Inf" if le == float("inf") else le, c]
                                for le, c in h.cumulative()],
                    "sum": round(h.total, 6), "count": h.count}
        return {name: shape(h) for name, h in self._stages.items()}

    def state_dict(self) -> dict:
        """Everything the serve checkpoint persists about metrics: every
        bucket's counters/latency, the stage histograms, and the
        server-wide uptime."""
        return {"uptime_s": time.perf_counter() - self.t0,
                "buckets": {bid: m.state_dict()
                            for bid, m in self._buckets.items()},
                "stages": {name: h.state_dict()
                           for name, h in self._stages.items()}}

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` — fault counters and uptime carry
        across the restore, so ``metrics_snapshot()`` tells one
        continuous story over the crash boundary."""
        self.t0 = time.perf_counter() - float(state["uptime_s"])
        for bid, mstate in state["buckets"].items():
            self.bucket(bid).load_state(mstate)
        for name, hstate in state["stages"].items():
            self.stage(name).load_state(hstate)

    def __iter__(self):
        return iter(self._buckets.values())

    def snapshot(self) -> list[dict]:
        return [m.snapshot() for m in self._buckets.values()]

    def totals(self) -> dict:
        lat = Histogram.latency_ms()
        for m in self:
            lat.merge(m.latency)
        frames = sum(m.frames for m in self)
        pad = sum(m.pad_frames for m in self)
        bits = sum(m.bits for m in self)
        uptime = time.perf_counter() - self.t0
        out = {"launches": sum(m.launches for m in self),
               "windows": sum(m.windows for m in self),
               "frames": frames, "pad_frames": pad, "bits": bits,
               "occupancy": frames / (frames + pad) if frames + pad else 0.0,
               "p50_ms": lat.percentile(50), "p99_ms": lat.percentile(99),
               "uptime_s": round(uptime, 3),
               "mbps": round(bits / uptime / 1e6 if uptime > 0 else 0.0, 4)}
        out.update({c: sum(getattr(m, c) for m in self)
                    for c in FAULT_COUNTERS})
        healths = [m.health for m in self]
        out["health"] = ("degraded" if "degraded" in healths else
                         "impaired" if "impaired" in healths else "ok")
        return out
