"""Session and bucket bookkeeping for the decode service (port of
``repro.serve.scheduler``).

A **session** is one tenant: a code configuration plus an unbounded LLR
stream, carried by a ``core.stream.StreamContext`` (rolling v1/v2 overlap
buffer, stream-global depuncture phase). A **bucket** groups live
sessions whose windows can share one batched kernel launch: same trellis,
same frame spec, same plan (``DecodePlan.cache_key()``), same
backend/interpret/mesh. The puncture rate is deliberately NOT part of the
bucket key — depuncturing happens per-session inside the context, so a
rate-1/2 and a rate-3/4 tenant of the same trellis/spec decode in the
same launch.

Scheduling is FIFO over each bucket's window queue (arrival order ==
round-robin when sessions push at similar rates); the server pops up to
``slots`` windows per bucket per step and pads the rest of the fixed
``slots * chunk_frames`` batch with zero frames.

Each ``PendingWindow`` stamps ``t_enq`` at enqueue; the server turns
(take time - t_enq) into the ``queue_wait_ms`` stage histogram
(serve.metrics.STAGES) and the end-to-end window latency at retire — the
queue is where a window's latency story starts.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ..core.pipeline import DecoderConfig
from ..core.stream import StagingPool, StreamContext, Window
from ..kernels.autotune import DecodePlan, plan_decode
from ..kernels.ops import resolve_device

__all__ = ["PendingWindow", "Session", "Bucket", "Breaker", "bucket_plan"]


class Breaker:
    """Per-bucket circuit breaker over the batched-launch path.

    Classic three-state machine, counted in consecutive launch-attempt
    failures (each retry attempt that raises or times out is one
    failure; any fast-path success resets the streak):

      * ``closed``    — normal; ``threshold`` consecutive failures trip
        it OPEN (the device-failure signal: retries are not clearing the
        fault).
      * ``open``      — the fast path is not attempted at all; the
        server evacuates the bucket's sessions to its failover bucket
        (pinned to the reference backend). After
        ``cooldown`` server steps the breaker goes HALF-OPEN.
      * ``half_open`` — the next batch is used as a probe on the
        original fast path: success closes the breaker (sessions move
        back), failure re-opens it (a fresh trip, a fresh cooldown).

    Every open transition is a *trip*, counted here and in the bucket's
    ``breaker_trips`` fault counter / health.
    """

    def __init__(self, threshold: int = 5, cooldown: int = 4):
        assert threshold > 0 and cooldown > 0
        self.threshold = threshold
        self.cooldown = cooldown
        self.state = "closed"
        self.consecutive = 0          # failures since the last success
        self.trips = 0                # open transitions, cumulative
        self._wait = 0                # steps left in the open cooldown

    def record_failure(self) -> bool:
        """One failed launch attempt; returns True when THIS failure
        trips the breaker open (closed -> open, or a failed half-open
        probe re-opening)."""
        self.consecutive += 1
        if self.state == "half_open" or (
                self.state == "closed"
                and self.consecutive >= self.threshold):
            self.state = "open"
            self._wait = self.cooldown
            self.trips += 1
            return True
        return False

    def record_success(self) -> bool:
        """One successful fast-path launch; returns True when it closes
        a half-open breaker (the probe succeeded — the device is back)."""
        self.consecutive = 0
        if self.state == "half_open":
            self.state = "closed"
            return True
        return False

    def step(self) -> None:
        """One server step elapsed; an open breaker counts down to its
        half-open probe."""
        if self.state == "open":
            self._wait -= 1
            if self._wait <= 0:
                self.state = "half_open"

    def state_dict(self) -> dict:
        return {"state": self.state, "consecutive": self.consecutive,
                "trips": self.trips, "wait": self._wait}

    def load_state(self, state: dict) -> None:
        if state["state"] not in ("closed", "open", "half_open"):
            raise ValueError(f"unknown breaker state {state['state']!r}")
        self.state = state["state"]
        self.consecutive = int(state["consecutive"])
        self.trips = int(state["trips"])
        self._wait = int(state["wait"])

    def snapshot(self) -> dict:
        """JSON-ready row for ``metrics_snapshot()['breakers']``."""
        return {"state": self.state, "trips": self.trips,
                "consecutive": self.consecutive}


def bucket_plan(cfg: DecoderConfig, num_devices: int = 1,
                chunk_frames: int | None = None, device=None) -> DecodePlan:
    """The DecodePlan a session of ``cfg`` buckets under — same planning
    call the single-stream front-end uses, so a server session chunks
    exactly like its ``stream_decode`` baseline. ``device=None`` is
    ``"cuda"``; there, planning loads the libraries of every kernel the
    bucket will launch (kernels.autotune.plan_decode), so a build failure
    surfaces at admission, never inside the server's retried launch."""
    pinned = (cfg.frames_per_tile
              if isinstance(cfg.frames_per_tile, int) else None)
    return plan_decode(
        cfg.trellis, cfg.spec, unified=cfg.backend != "kernel_split",
        pack_survivors=cfg.pack_survivors, radix=cfg.radix,
        bm_dtype=cfg.bm_dtype, layout=cfg.layout, num_devices=num_devices,
        chunk_frames=chunk_frames, frames_per_tile=pinned,
        block_frames=cfg.block_frames, overlap=cfg.overlap, device=device)


@dataclasses.dataclass
class PendingWindow:
    """One chunk window queued for a batched launch."""
    session: "Session"
    frames: np.ndarray            # (chunk_frames, L, beta) float32
    n_bits: int                   # real bits (tail windows carry padding)
    t_enq: float                  # perf_counter at enqueue: queue_wait_ms
                                  # stage + end-to-end latency both start here


@dataclasses.dataclass
class Session:
    """One tenant stream and its decoded-output queue.

    ``strikes`` counts pushes that failed input validation (poisoned or
    malformed LLRs); once it reaches the server's ``quarantine_after``
    threshold the session is quarantined: ``quarantined`` holds the
    machine-readable reason, further pushes/polls raise
    ``SessionQuarantined``, and only ``close_session`` (teardown) still
    succeeds — one bad tenant never takes down its bucket."""
    sid: int
    cfg: DecoderConfig
    ctx: StreamContext
    bucket: "Bucket"
    inflight: int = 0             # windows queued, not yet decoded
    ready: list = dataclasses.field(default_factory=list)
    closed: bool = False
    strikes: int = 0              # validation failures so far
    quarantined: str | None = None  # reason, once quarantined
    chunk_frames_arg: int | None = None  # open_session arg, for restore

    def _enqueue(self, w: Window) -> None:
        assert w.nframes == self.bucket.chunk_frames    # one bucket geometry
        self.bucket.queue.append(
            PendingWindow(self, w.frames(self.cfg.spec), w.n_bits,
                          time.perf_counter()))
        self.inflight += 1

    def absorb(self, llr) -> int:
        """Feed raw input through the context; queue every completed
        window on the bucket. Returns windows queued."""
        self.ctx.append(llr)
        windows = self.ctx.take_windows()
        for w in windows:
            self._enqueue(w)
        return len(windows)

    def finish(self) -> int:
        """Queue the zero-padded tail as full-chunk windows (the tail can
        exceed one chunk by up to v2-1 stages of missing right context —
        flush_chunks splits it losslessly). Returns windows queued."""
        windows = self.ctx.flush_chunks()
        for w in windows:
            self._enqueue(w)
        return len(windows)

    def take_ready(self) -> np.ndarray:
        out = (np.concatenate(self.ready) if self.ready
               else np.zeros((0,), np.int32))
        self.ready.clear()
        return out


class Bucket:
    """Live sessions sharing one plan — and one launch per step.

    ``mesh`` is the bucket's device placement (the server's mesh for
    primary buckets; None for a failover bucket — device loss means the
    evacuation target is the reference path on one device). ``device`` is
    where the bucket's launches run (the mesh's home device under a mesh);
    ``staging`` holds its pinned host buffers
    (core.stream.StagingPool), one per launch in flight. ``pinned`` marks a
    failover bucket: its launches are pinned to the reference backend,
    never consult the fault injector (the evacuation target is the path
    that must work when the fast path doesn't — same contract as
    ``_ref_fallback``), and ``primary`` points back at the bucket whose
    breaker evacuation created it (half-open probes re-dispatch on the
    primary's fast path)."""

    def __init__(self, key, cfg: DecoderConfig, plan: DecodePlan, *,
                 mesh=None, pinned: bool = False, primary=None,
                 breaker: Breaker | None = None, device=None):
        self.key = key
        self.plan = plan
        self.chunk_frames = plan.chunk_frames
        # the decode identity strips the rate: depuncture is per-session
        # upstream, so every rate shares this bucket's decode programs
        self.decode_cfg = dataclasses.replace(cfg, rate="1/2")
        self.sessions: set[int] = set()
        self.queue: collections.deque[PendingWindow] = collections.deque()
        self.inflight: collections.deque = collections.deque()  # launches
        self.mesh = mesh
        self.device = resolve_device(device)
        self.staging = StagingPool(self.device)
        self.pinned = pinned
        self.primary: "Bucket | None" = primary
        self.breaker = breaker if breaker is not None else Breaker()
        self.id = (f"K{cfg.trellis.k}-f{cfg.spec.f}-"
                   f"C{self.chunk_frames}-{plan.fingerprint()}"
                   + ("-failover" if pinned else ""))

    def tile_pad(self, batch_frames: int) -> int:
        """Frames of tile padding a launch of ``batch_frames`` pays: the
        kernel wrappers round the frame axis up to the plan's tile
        (ops._pad_frames); the reference backend decodes exactly. Under a
        block-parallel plan the kernel's frame axis carries BLOCKS
        (batch_frames * block_frames of them), so the rounding happens in
        block units and the result is converted back to outer frames."""
        if self.decode_cfg.backend == "reference":
            return 0
        bf = self.plan.block_frames
        units = batch_frames * bf
        ft = self.plan.frames_per_tile
        return (-(-units // ft) * ft - units) // bf

    def take(self, max_windows: int) -> list[PendingWindow]:
        out = []
        while self.queue and len(out) < max_windows:
            w = self.queue.popleft()
            w.session.inflight -= 1
            out.append(w)
        return out
