"""Fixed-bucket histograms: O(1) record, O(buckets) percentiles (port of
``repro.obs.hist``, pure Python, copied).

The serve metrics used to keep a 4096-sample deque per bucket and
re-concatenate every sample on each ``totals()`` call — O(all samples)
per snapshot, and a hard cap on how much history a percentile can see.
A fixed-bucket histogram inverts the trade: recording is one bisect into
a static bound table, snapshots walk the (constant) bucket array, memory
is O(buckets) forever, and two histograms merge by adding counts — which
is exactly what ``ServeMetrics.totals()`` needs to aggregate buckets.

Percentiles are interpolated inside the containing bucket and clamped to
the observed [min, max], so they are exact for degenerate distributions
(one repeated value) and within one bucket's resolution otherwise. The
default latency bounds are geometric with ratio 2**0.25 (~19% per step)
from 1 ns to 100 s, so any latency percentile is within ~19% of the
exact sample percentile — tests/test_obs.py and
tests/test_torch_obs.py gate this against
``np.percentile``.

Pure stdlib (the obs layer is zero-dependency by design).
"""
from __future__ import annotations

import bisect

__all__ = ["Histogram", "geometric_bounds", "LATENCY_MS_BOUNDS",
           "SIZE_BOUNDS"]


def geometric_bounds(lo: float, hi: float, ratio: float) -> tuple:
    """Increasing bucket upper-edges ``lo, lo*ratio, ...`` up past ``hi``."""
    assert lo > 0 and ratio > 1 and hi > lo
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return tuple(out)


#: Latency bounds (milliseconds): 1e-3 ms .. 1e5 ms, ~19%/bucket.
LATENCY_MS_BOUNDS = geometric_bounds(1e-3, 1e5, 2 ** 0.25)

#: Size bounds (counts — frames, bits, bytes): powers of two to 2**30.
SIZE_BOUNDS = tuple(float(1 << i) for i in range(31))


class Histogram:
    """Fixed-bucket scalar histogram.

    ``bounds`` are increasing bucket *upper* edges; bucket i holds values
    in (bounds[i-1], bounds[i]] (bucket 0: [0, bounds[0]]), plus one
    overflow bucket past the last edge. All histograms built from the
    same bounds can ``merge``.
    """

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds=LATENCY_MS_BOUNDS):
        bounds = tuple(float(b) for b in bounds)
        assert bounds and all(a < b for a, b in zip(bounds, bounds[1:]))
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    @classmethod
    def latency_ms(cls) -> "Histogram":
        return cls(LATENCY_MS_BOUNDS)

    @classmethod
    def sizes(cls) -> "Histogram":
        return cls(SIZE_BOUNDS)

    def record(self, x) -> None:
        x = float(x)
        self.counts[bisect.bisect_left(self.bounds, x)] += 1
        self.count += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x

    def extend(self, xs) -> None:
        for x in xs:
            self.record(x)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (same bounds required); returns self."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p-th percentile (0.0 when empty): linear interpolation inside
        the containing bucket, clamped to the observed [min, max]."""
        if not self.count:
            return 0.0
        target = max(1e-12, (p / 100.0) * self.count)
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                frac = (target - cum) / c
                val = lo + frac * max(0.0, hi - lo)
                return min(max(val, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def cumulative(self) -> list:
        """``(upper_bound, cumulative_count)`` per bucket, ending with
        ``(inf, count)`` — the Prometheus histogram exposition shape
        (``_bucket{le=...}`` samples are cumulative and always include
        the ``+Inf`` bucket)."""
        out, cum = [], 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            out.append((bound, cum))
        out.append((float("inf"), self.count))
        return out

    def snapshot(self) -> dict:
        """JSON-ready summary (keys shared by the stage-latency rows in
        ``metrics_snapshot()`` and the Prometheus exposition)."""
        return {"count": self.count, "total": round(self.total, 3),
                "mean": round(self.mean(), 4),
                "p50": round(self.percentile(50), 4),
                "p99": round(self.percentile(99), 4),
                "max": round(self.vmax, 4) if self.count else 0.0}

    def state_dict(self) -> dict:
        """Full JSON-ready state (counts included), for the serve
        checkpoint: a restored histogram keeps reporting the same
        percentiles the pre-crash server did. ``vmin``/``vmax`` are None
        while empty (JSON has no +-inf)."""
        return {"counts": list(self.counts), "count": self.count,
                "total": self.total,
                "vmin": self.vmin if self.count else None,
                "vmax": self.vmax if self.count else None}

    def load_state(self, state: dict) -> "Histogram":
        """Restore a ``state_dict`` into this histogram (whose bounds
        must have the same bucket count); returns self."""
        counts = list(state["counts"])
        if len(counts) != len(self.counts):
            raise ValueError(
                f"histogram state has {len(counts)} buckets, this "
                f"histogram has {len(self.counts)}")
        self.counts = [int(c) for c in counts]
        self.count = int(state["count"])
        self.total = float(state["total"])
        self.vmin = float("inf") if state["vmin"] is None \
            else float(state["vmin"])
        self.vmax = float("-inf") if state["vmax"] is None \
            else float(state["vmax"])
        return self
