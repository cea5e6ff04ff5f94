"""Deterministic fault injection for the decode service and stream layer
(port of ``repro.testing.faults``, numpy, copied: the same seed gives the
same schedule and the same corrupted arrays).

The serve robustness machinery (retry/backoff, deadline, degraded-mode
fallback, quarantine — repro_torch.serve.server) is only testable if the faults
it guards against can be produced ON DEMAND and REPRODUCIBLY. This module
is that harness: a ``FaultInjector`` holds a schedule of ``FaultSpec``
entries and is consulted from three hook points —

  * ``launch(bucket_id)``   — before a batched kernel launch is
    dispatched (``DecodeServer._launch`` / ``StreamDecoder._dispatch``).
    May raise ``InjectedKernelError`` (a failed launch) or sleep
    ``delay_s`` seconds (a slow/hung launch, which the server's
    per-launch deadline then converts into a timeout).
  * ``corrupt(llr, sid=)``  — at the push boundary
    (``DecodeServer.push`` / ``StreamDecoder.push``). Returns the input
    with a ``frac`` fraction of entries overwritten by NaN/Inf/huge
    values (a poisoned tenant); ``sessions`` restricts the blast radius
    to specific session ids.
  * ``plan_cache_miss()``   — before the plan-cache lookup.
    True forces the server to drop and rebuild the cached program (a
    cold-cache / evicted-plan event).

Schedules are deterministic two ways: ``every=N`` fires on every Nth
event of that kind (exact), and ``p`` fires probabilistically from one
seeded ``numpy`` Generator (reproducible for a fixed seed and call
order). Both can be combined. The injector never mutates its inputs and
keeps per-kind event/injection counters (``stats()``) that the serve
metrics snapshot surfaces next to the retry/degraded counters.

Production code never imports this module unless a ``faults=`` injector
is explicitly passed in — the hooks are ``None``-guarded no-ops.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault",
           "InjectedKernelError", "InjectedDeviceLoss", "InjectedCrash",
           "KINDS"]

#: Recognized fault kinds (one hook point each; see module docstring).
#: The durability kinds: ``device_loss`` makes every launch of a
#: matching bucket fail persistently over an ``after``/``count`` event
#: window (drives the per-bucket circuit breaker open, then lets the
#: half-open probe succeed once the window expires); ``crash_at_step``
#: raises ``InjectedCrash`` out of ``DecodeServer.step()`` — a simulated
#: process death the kill-restore-compare chaos test recovers from via
#: checkpoint/restore; ``checkpoint_corrupt`` flips bytes in a
#: checkpoint as it is written (the restore path must REJECT it with a
#: structured error, never half-load).
KINDS = ("launch_error", "launch_slow", "corrupt_llr", "plan_cache_miss",
         "device_loss", "crash_at_step", "checkpoint_corrupt")

#: corrupt_llr poison values by mode ('huge' is finite but far beyond any
#: sane LLR magnitude — exercises the out-of-range clamp, not the
#: non-finite scrub).
_POISON = {"nan": np.nan, "inf": np.inf, "huge": np.float32(1e30)}


class InjectedFault(RuntimeError):
    """Base class for every exception raised BY the injector."""


class InjectedKernelError(InjectedFault):
    """An injected kernel-launch failure (stands in for a kernel
    build or launch error escaping the launch)."""


class InjectedDeviceLoss(InjectedKernelError):
    """An injected PERSISTENT launch failure (stands in for a lost /
    wedged accelerator: every launch on that device fails until the
    fault window closes). Subclasses InjectedKernelError so the serve
    retry machinery sees it as a launch error — the point is that
    retries do NOT clear it, which is what trips the circuit breaker."""


class InjectedCrash(InjectedFault):
    """An injected process crash (raised out of ``DecodeServer.step``,
    NOT caught by the server's own fault handling — the process is
    'dead'; recovery is checkpoint/restore in a fresh server)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    kind:     one of ``KINDS``.
    p:        per-event probability (seeded; 0 disables).
    every:    also fire deterministically on every Nth event (0 disables).
    after:    also fire deterministically on every event from the
              ``after``-th onward (0 disables) — a PERSISTENT fault
              window, bounded by ``count``. This is how device_loss and
              crash_at_step schedules are written.
    count:    with ``after``: how many consecutive events fire (0 =
              unbounded).
    delay_s:  launch_slow — simulated hang duration in seconds.
    mode:     corrupt_llr — 'nan' | 'inf' | 'huge'.
    frac:     corrupt_llr — fraction of entries poisoned (at least one).
    sessions: corrupt_llr — restrict to these session ids (empty = all).
    bucket:   device_loss — restrict to bucket ids containing this
              substring ('' = every bucket; the 'device' that dies).
    """
    kind: str
    p: float = 0.0
    every: int = 0
    after: int = 0
    count: int = 0
    delay_s: float = 0.0
    mode: str = "nan"
    frac: float = 0.25
    sessions: tuple = ()
    bucket: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.mode not in _POISON:
            raise ValueError(f"unknown corrupt_llr mode {self.mode!r}; "
                             f"expected one of {tuple(_POISON)}")
        if not (0.0 <= self.p <= 1.0 and 0.0 < self.frac <= 1.0
                and self.every >= 0 and self.delay_s >= 0.0
                and self.after >= 0 and self.count >= 0):
            raise ValueError(f"out-of-range FaultSpec parameters: {self}")


class FaultInjector:
    """A seeded schedule of faults, consulted at the serve/stream hooks."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self._specs: dict[str, list[FaultSpec]] = collections.defaultdict(list)
        for s in specs:
            self._specs[s.kind].append(s)
        self._rng = np.random.default_rng(seed)
        self._events = collections.Counter()    # hook calls per kind
        self.injected = collections.Counter()   # faults fired per kind

    def _fire(self, kind: str, accept=None) -> FaultSpec | None:
        """One event of ``kind``: returns the first spec that fires.

        Every spec with p > 0 draws from the seeded generator on every
        event, so the schedule is a pure function of (seed, call order)
        regardless of which specs fire.
        """
        self._events[kind] += 1
        n = self._events[kind]
        hit = None
        for spec in self._specs.get(kind, ()):
            fires = spec.every > 0 and n % spec.every == 0
            if spec.after > 0 and n >= spec.after \
                    and (spec.count == 0 or n < spec.after + spec.count):
                fires = True
            if spec.p > 0.0 and self._rng.random() < spec.p:
                fires = True
            if fires and hit is None and (accept is None or accept(spec)):
                hit = spec
        if hit is not None:
            self.injected[kind] += 1
        return hit

    # -- hooks (all no-ops unless a matching spec fires) -------------------
    def launch(self, bucket_id: str = "") -> None:
        """Launch-path hook: may sleep (slow launch) and/or raise. A
        matching ``device_loss`` spec raises ``InjectedDeviceLoss`` —
        persistent over its after/count window, which is what drives a
        bucket's circuit breaker open."""
        loss = self._fire("device_loss",
                          accept=lambda s: s.bucket in bucket_id)
        if loss is not None:
            raise InjectedDeviceLoss(
                f"injected device loss (bucket {bucket_id or '?'}): every "
                f"launch on this device fails")
        slow = self._fire("launch_slow")
        if slow is not None:
            time.sleep(slow.delay_s)
        if self._fire("launch_error") is not None:
            raise InjectedKernelError(
                f"injected kernel-launch failure (bucket {bucket_id or '?'})")

    def corrupt(self, llr, sid: int | None = None):
        """Push-boundary hook: returns ``llr`` with poisoned entries (a
        copy), or the input untouched when no spec fires."""
        spec = self._fire(
            "corrupt_llr",
            accept=lambda s: not s.sessions or sid in s.sessions)
        arr = np.asarray(llr, np.float32)
        if spec is None or arr.size == 0:
            return llr
        out = arr.copy()
        flat = out.reshape(-1)
        k = max(1, int(spec.frac * flat.size))
        idx = self._rng.choice(flat.size, size=k, replace=False)
        vals = np.full(k, _POISON[spec.mode], np.float32)
        if spec.mode != "nan":                  # both signs of inf/huge
            vals[1::2] = -vals[1::2]
        flat[idx] = vals
        return out

    def plan_cache_miss(self) -> bool:
        """Cache-lookup hook: True forces a rebuild of the cached plan."""
        return self._fire("plan_cache_miss") is not None

    def crash(self, where: str = "step") -> None:
        """Crash hook (``DecodeServer.step`` calls it first thing): a
        firing ``crash_at_step`` spec raises ``InjectedCrash`` — the
        simulated process death. Deliberately OUTSIDE the server's
        try/except fault handling: nothing in the dying process recovers;
        a fresh process restores from the last checkpoint."""
        if self._fire("crash_at_step") is not None:
            raise InjectedCrash(
                f"injected crash at {where} event "
                f"{self._events['crash_at_step']}")

    def checkpoint_bytes(self, data: bytes) -> bytes:
        """Checkpoint-write hook: a firing ``checkpoint_corrupt`` spec
        returns ``data`` with bytes flipped mid-payload (torn/bit-rotted
        write). The restore path must detect it via the CRC and refuse
        to load — never half-restore."""
        if self._fire("checkpoint_corrupt") is None or len(data) < 8:
            return data
        out = bytearray(data)
        mid = len(out) // 2
        for i in range(mid, min(mid + 4, len(out))):
            out[i] ^= 0x5A
        return bytes(out)

    def stats(self) -> dict:
        """JSON-ready counters: hook events seen / faults injected."""
        return {"events": dict(self._events),
                "injected": dict(self.injected)}
