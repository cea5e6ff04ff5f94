"""DecodeServer: a multi-tenant, slot-based Viterbi decode service (port
of ``repro.serve.server``).

Continuous-batching for receivers instead of language models: sessions
(each a code config + an unbounded LLR stream) are admitted into the
server, grouped into buckets by (trellis, spec, plan), and each
``step()`` packs up to ``slots`` pending chunk windows per bucket into
ONE batched kernel launch (partial batches are padded to the plan's tile
multiple inside the kernel wrapper — ``chunk_frames`` is already a tile
multiple, so a full-slot launch pads nothing). Per-session bits come
back bit-identical to running that session
alone through ``core.stream.stream_decode``: frames decode independently,
and the per-session chunking/flush geometry is exactly the single-stream
context's.

The plan cache (plan_cache.PLAN_CACHE by default) guarantees tenant
churn never rebuilds a program: one per (trellis, spec, plan,
batch-nframes, device) bucket for the lifetime of the process.

Flow control is explicit and synchronous:

  * admission — ``open_session`` raises ``ServerFull`` beyond
    ``max_sessions`` live sessions;
  * backpressure — ``push`` raises ``Backpressure`` once a session has
    ``queue_depth`` windows pending (call ``step()`` to drain, then
    retry);
  * ``step()`` runs one launch per bucket with pending work; ``poll``
    collects a session's decoded bits; ``close_session`` flushes the
    tail, drains, and frees the slot.

All flow-control and per-session failures derive from ``ServeError``,
which carries a machine-readable ``retry_after_steps`` hint (how many
``step()`` calls should clear the condition; None when retrying won't
help). The server loop itself NEVER dies on a bad tenant or a bad
launch; errors surface on that session's ``push``/``poll``.

Fault tolerance (one poisoned buffer or failed launch must not corrupt
a bucket):

  * input hardening — every ``push`` is validated and (by default)
    sanitized: NaN/Inf become neutral zero LLRs, |llr| > ``llr_clip``
    clamps (core.sanitize; bit-identical on clean inputs). A push that
    fails validation is a STRIKE; after ``quarantine_after`` strikes the
    session is quarantined — further ``push``/``poll`` raise
    ``SessionQuarantined`` (structured: sid/reason/strikes) while
    ``close_session`` still tears it down cleanly.
  * launch deadline + retry — a batched launch that raises, or exceeds
    ``launch_timeout_s`` wall-clock, is retried up to ``max_retries``
    times with exponential backoff (``backoff_s * 2**attempt``).
  * graceful degrade — when retries are exhausted the batch is decoded
    by the reference backend (``backend='reference'``, bit-identical to
    the kernels at fp32) instead of the bucket's kernel fast path, so
    healthy sessions still get correct bits; the bucket's ``degraded``
    counter and ``health`` reflect it.
  * observability — per-bucket error/retry/timeout/degraded/quarantine
    counters and a health field in ``metrics_snapshot()``.

``faults=`` accepts a ``repro_torch.testing.faults.FaultInjector`` whose
seeded schedule exercises all of the above deterministically (kernel
exceptions, slow launches, poisoned LLRs, plan-cache evictions); it is
None in production and every hook is pay-nothing when unset. The
deadline is cooperative, as in the JAX package: a launch is
asynchronous, so the deadline measures the dispatch (and is observed
again at materialize time) rather than interrupting the kernel.

On the card (port). A batch is packed into one of the bucket's pinned
host buffers and copied to the device without blocking; the kernel
launches on the current stream and its bits come back, again without
blocking, into the pinned buffer, gated by one CUDA event per launch
(core.stream.StagingPool). ``_retire`` waits on the oldest launch's event
only. The retry/degrade machinery absorbs any exception of a launch
EXCEPT a CUDA error: that one is sticky — the context is unusable after
it — so it propagates instead of being retried or degraded in-process.
The kernels of a bucket are built when it is planned (``open_session``),
outside the retried launch, so a build failure is never absorbed either.
The failover and degrade paths run the reference backend on the server's
device, as the JAX package runs its reference on its default device.

With ``mesh=...`` (a ``distributed.FrameMesh``) every bucket's batch is
sharded across the mesh's devices (distributed/stream.py): the batch is
the frame axis, so the scale-out of the single stream carries over. The
pinned buffers, the batches and the events live on the mesh's home
device, which is the server's ``device``; the failover bucket runs on it
alone (``mesh=None``: the mesh is the thing we do not trust).

Durability (the service survives bad *processes* and bad
*devices*, not just bad inputs and bad launches):

  * checkpoint/restore — ``checkpoint(path)`` writes an atomic
    (tmp+rename), CRC-validated, schema-versioned snapshot of the whole
    server: every session's bounded carry state
    (``StreamContext.state_dict()``), undelivered decoded bits, queued
    windows, quarantine strikes, circuit-breaker states, and the full
    fault/metric counters. ``DecodeServer.restore(path)`` rebuilds an
    equivalent server in a fresh process; every restored stream resumes
    BIT-IDENTICALLY (serve/checkpoint.py; corrupt or version-mismatched
    files raise ``CheckpointError`` — never a half-loaded server).
  * drain — ``drain(checkpoint=path)`` stops admitting (``Draining`` on
    ``open_session``/``push``), retires every in-flight launch, and
    snapshots: the operational stop-the-world handoff (drain -> snapshot
    -> restart elsewhere).
  * circuit breakers + failover — ``threshold`` consecutive launch
    failures on a bucket trip its breaker OPEN (the device-failure
    signal): its sessions and queued windows are EVACUATED to a failover
    bucket pinned to the reference backend, counted in
    ``breaker_trips``/``evacuated`` and
    visible in ``metrics_snapshot()['breakers']`` and health. After a
    cooldown the breaker half-opens and the next batch probes the
    original fast path; success closes it and moves the sessions back.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.pipeline import DecoderConfig
from ..core.sanitize import LLR_CLIP, sanitize_llr
from ..core.stream import StreamContext, _host_array
from ..obs.tracer import get_tracer
from .metrics import ServeMetrics
from .plan_cache import PLAN_CACHE, PlanCache, resolve_placement
from .scheduler import Breaker, Bucket, Session, bucket_plan

__all__ = ["DecodeServer", "ServeError", "ServerFull", "Backpressure",
           "PoisonedInput", "SessionQuarantined", "LaunchTimeout",
           "Draining"]


def _is_device_error(exc: BaseException) -> bool:
    """A CUDA error (torch's, or a kernel wrapper's failed launch)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


class ServeError(RuntimeError):
    """Base class of every serve-layer error.

    ``retry_after_steps`` is a machine-readable hint: how many ``step()``
    calls the caller should drive before retrying the failed operation
    (None = retrying will not help; fix the condition instead)."""

    def __init__(self, msg: str, *, retry_after_steps: int | None = None):
        super().__init__(msg)
        self.retry_after_steps = retry_after_steps


class ServerFull(ServeError):
    """Admission refused: the server is at max_sessions live sessions."""


class Backpressure(ServeError):
    """Push refused: the session already has queue_depth windows pending.

    The caller should drive ``step()`` (``retry_after_steps`` estimates
    how many) and retry."""


class PoisonedInput(ServeError):
    """Push rejected by input validation (malformed shape, or poisoned
    values under the 'raise' sanitize policy). Counts one strike toward
    quarantine; the push absorbed nothing, so a corrected retry is safe."""

    def __init__(self, msg: str, *, sid: int, n_bad: int = 0):
        super().__init__(msg, retry_after_steps=None)
        self.sid = sid
        self.n_bad = n_bad


class SessionQuarantined(ServeError):
    """The session exceeded the validation-failure threshold and is
    quarantined: pushes and polls are refused (structured sid/reason/
    strikes); ``close_session`` still works and returns any bits decoded
    before quarantine."""

    def __init__(self, sid: int, reason: str, strikes: int):
        super().__init__(
            f"session {sid} is quarantined after {strikes} input-validation "
            f"failures (last: {reason}); close_session() to tear it down",
            retry_after_steps=None)
        self.sid = sid
        self.reason = reason
        self.strikes = strikes


class LaunchTimeout(ServeError):
    """A batched launch exceeded the per-launch deadline (internal retry
    signal; surfaces only in bucket metrics/last_error)."""


class Draining(ServeError):
    """The server is draining toward a snapshot/handoff: admission and
    pushes are refused (``retry_after_steps`` is None — retry against
    the RESTORED server, not this one); ``step``/``poll``/
    ``close_session`` keep working so in-flight work retires cleanly."""

    def __init__(self, what: str):
        super().__init__(
            f"server is draining; {what} refused — finish the snapshot "
            f"and retry against the restored server",
            retry_after_steps=None)


class DecodeServer:
    """Slot-based batching decode service over heterogeneous sessions.

    slots:        max windows batched per bucket per step. A steady-state
                  full bucket launches ``slots * chunk_frames`` frames in
                  one fixed shape — one program per bucket, regardless of
                  session churn (drain tails add at most one shape per
                  distinct partial batch size, each built once).
    max_sessions: admission limit over all buckets.
    queue_depth:  per-session pending-window limit before Backpressure.
    depth:        batched launches allowed in flight per bucket behind
                  the dispatch front (1 = double buffering, as in
                  StreamDecoder; 0 = synchronous, for debugging).
    mesh:         optional distributed.FrameMesh; bucket batches are then
                  sharded across its devices (``device`` must be None or
                  the mesh's home device).
    device:       where every bucket launches (None = "cuda"; raises
                  without a card unless "cpu").
    cache:        PlanCache override (default: process-global PLAN_CACHE).
    launch_timeout_s: per-launch wall-clock deadline (None = no deadline).
    max_retries:  re-dispatch attempts after a failed/timed-out launch
                  before degrading to the reference fallback.
    backoff_s:    base retry backoff; attempt i sleeps backoff_s * 2**i.
    sanitize:     push input policy — 'zero' (scrub NaN/Inf, clamp
                  out-of-range; default), 'raise' (reject poisoned
                  pushes), 'off' (trust the tenant).
    llr_clip:     out-of-range magnitude threshold for sanitization.
    quarantine_after: validation-failure strikes before a session is
                  quarantined.
    faults:       optional repro_torch.testing.faults.FaultInjector
                  (tests/chaos only; None in production).
    trace:        optional repro_torch.obs.Tracer recording push/launch/
                  retry/retire spans and stage latencies. None (default)
                  resolves to the process-global tracer — a pay-nothing
                  no-op unless ``repro_torch.obs.set_tracer`` enabled one.
    """

    def __init__(self, *, slots: int = 4, max_sessions: int = 64,
                 queue_depth: int = 8, depth: int = 1, mesh=None,
                 cache: PlanCache | None = None,
                 launch_timeout_s: float | None = None,
                 max_retries: int = 2, backoff_s: float = 0.01,
                 sanitize: str = "zero", llr_clip: float = LLR_CLIP,
                 quarantine_after: int = 3,
                 breaker_threshold: int = 5, breaker_cooldown: int = 4,
                 faults=None, trace=None, device=None):
        assert slots > 0 and max_sessions > 0 and queue_depth > 0
        assert depth >= 0
        assert max_retries >= 0 and backoff_s >= 0.0
        assert quarantine_after > 0
        assert breaker_threshold > 0 and breaker_cooldown > 0
        assert sanitize in ("zero", "raise", "off")
        mesh, self.device = resolve_placement(mesh, device)
        self.slots = slots
        self.max_sessions = max_sessions
        self.queue_depth = queue_depth
        self.depth = depth                    # launches left in flight
        self.mesh = mesh
        self.cache = cache if cache is not None else PLAN_CACHE
        self.launch_timeout_s = launch_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.sanitize = sanitize
        self.llr_clip = llr_clip
        self.quarantine_after = quarantine_after
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.faults = faults
        self.trace = trace if trace is not None else get_tracer()
        self.metrics = ServeMetrics()
        self._sessions: dict[int, Session] = {}
        self._buckets: dict[tuple, Bucket] = {}
        self._next_sid = 0
        self._draining = False
        self.checkpoint_saves = 0
        self.checkpoint_restores = 0

    def init_kwargs(self) -> dict:
        """The JSON-serializable constructor knobs — what the checkpoint
        persists so ``restore`` rebuilds an equivalently configured
        server (mesh/cache/faults/trace/device are process-local and
        passed fresh at restore time; the keys are the JAX package's, so
        a checkpoint restores in either package)."""
        return {"slots": self.slots, "max_sessions": self.max_sessions,
                "queue_depth": self.queue_depth, "depth": self.depth,
                "launch_timeout_s": self.launch_timeout_s,
                "max_retries": self.max_retries,
                "backoff_s": self.backoff_s, "sanitize": self.sanitize,
                "llr_clip": float(self.llr_clip),
                "quarantine_after": self.quarantine_after,
                "breaker_threshold": self.breaker_threshold,
                "breaker_cooldown": self.breaker_cooldown}

    # -- admission --------------------------------------------------------
    @property
    def num_sessions(self) -> int:
        return len(self._sessions)

    def open_session(self, cfg: DecoderConfig,
                     chunk_frames: int | None = None, *,
                     low_latency: bool = False) -> int:
        """Admit one tenant; returns its session id. Sessions of the same
        (trellis, spec, plan) — any puncture rate — share a bucket. A
        bucket whose circuit breaker is not closed admits new sessions
        straight onto its failover bucket (no tenant is placed on a
        known-bad device); a draining server refuses admission.

        ``low_latency=True`` is the latency-SLO option: it sets
        ``block_frames='auto'`` on the session's config (unless the
        tenant already chose a block decomposition), so long frames are
        decoded as many short intra-frame blocks — each kernel launch
        scans f/block_frames + 2*overlap stages instead of v1+f+v2,
        shrinking per-window launch latency at the truncated-traceback
        BER cost documented on DecoderConfig. The plan's cache_key
        carries the resolved knobs, so low-latency sessions bucket
        separately from exact ones automatically."""
        if self._draining:
            raise Draining("open_session")
        if len(self._sessions) >= self.max_sessions:
            raise ServerFull(
                f"{len(self._sessions)} live sessions (max_sessions="
                f"{self.max_sessions}); close one or raise the limit")
        if low_latency and cfg.block_frames == 1:
            cfg = dataclasses.replace(cfg, block_frames="auto")
        return self._admit(cfg, chunk_frames)

    def _bucket_for(self, cfg: DecoderConfig,
                    chunk_frames: int | None) -> Bucket:
        ndev = self.mesh.size if self.mesh is not None else 1
        plan = bucket_plan(cfg, num_devices=ndev, chunk_frames=chunk_frames,
                           device=self.device)
        key = (cfg.trellis, cfg.spec, plan.cache_key(), cfg.backend,
               cfg.interpret, self.mesh)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = Bucket(
                key, cfg, plan, mesh=self.mesh,
                breaker=Breaker(self.breaker_threshold,
                                self.breaker_cooldown), device=self.device)
        return bucket

    def _failover_bucket(self, primary: Bucket) -> Bucket:
        """The evacuation target for ``primary``: same trellis/spec/plan
        geometry (windows stay launch-compatible), pinned to the
        reference backend on the server's device (``mesh=None`` — device
        loss means the mesh is the thing we do not trust)."""
        key = primary.key + ("failover",)
        bucket = self._buckets.get(key)
        if bucket is None:
            cfg = dataclasses.replace(primary.decode_cfg,
                                      backend="reference", renorm_every=1)
            bucket = self._buckets[key] = Bucket(
                key, cfg, primary.plan, mesh=None, pinned=True,
                primary=primary, device=self.device)
        return bucket

    def _admit(self, cfg: DecoderConfig, chunk_frames: int | None,
               sid: int | None = None) -> int:
        """Shared admission core for ``open_session`` and checkpoint
        ``restore`` (which replays saved sids)."""
        bucket = self._bucket_for(cfg, chunk_frames)
        if bucket.breaker.state != "closed":
            bucket = self._failover_bucket(bucket)
        if sid is None:
            sid = self._next_sid
            self._next_sid += 1
        # the server sanitizes at ITS push boundary (so strikes/counters
        # land on the session); the context's own scrub is off
        ctx = StreamContext(cfg.spec, cfg.trellis.beta, bucket.chunk_frames,
                            cfg.rate, sanitize="off")
        session = Session(sid, cfg, ctx, bucket)
        session.chunk_frames_arg = chunk_frames
        self._sessions[sid] = session
        bucket.sessions.add(sid)
        return sid

    def _session(self, sid: int) -> Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise KeyError(f"no live session {sid}") from None

    # -- input hardening --------------------------------------------------
    def _strike(self, session: Session, reason: str) -> None:
        """One validation failure; quarantine at the threshold."""
        bm = self.metrics.bucket(session.bucket.id)
        session.strikes += 1
        bm.record_fault("poisoned_pushes", error=reason)
        if session.quarantined is None \
                and session.strikes >= self.quarantine_after:
            session.quarantined = reason
            bm.record_fault("quarantined")

    def _validate_push(self, session: Session, llr):
        """Convert + validate + sanitize one push; returns the clean
        array. Strikes (and possibly quarantines) on failure."""
        try:
            arr = _host_array(llr)
        except (TypeError, ValueError) as e:
            reason = f"push is not numeric: {e}"
            self._strike(session, reason)
            raise PoisonedInput(f"session {session.sid}: {reason}",
                                sid=session.sid) from None
        try:
            session.ctx.check_shape(arr)
            if self.sanitize != "off":
                arr, n_bad = sanitize_llr(arr, self.llr_clip, self.sanitize)
            else:
                n_bad = 0
        except ValueError as e:
            self._strike(session, str(e))
            raise PoisonedInput(f"session {session.sid}: {e}",
                                sid=session.sid) from None
        if n_bad:
            # sanitized to safety — still a strike (a tenant repeatedly
            # sending poison gets quarantined even under 'zero' policy)
            bm = self.metrics.bucket(session.bucket.id)
            bm.record_fault("sanitized_values", n=n_bad)
            session.ctx.n_sanitized += n_bad    # session_state() visibility
            self._strike(session,
                         f"{n_bad} non-finite/out-of-range LLR values "
                         f"sanitized")
        return arr

    # -- data path --------------------------------------------------------
    def push(self, sid: int, llr) -> None:
        """Feed soft symbols (raw punctured stream for punctured-rate
        sessions) into a session. Validates and sanitizes first (see
        class docstring), then raises Backpressure — BEFORE absorbing
        anything, so a retry is safe — when the session's pending windows
        plus the windows this push would complete exceed queue_depth
        (call step() to drain, then retry; a single push bigger than
        queue_depth chunks must be split by the caller)."""
        session = self._session(sid)
        if self._draining:
            raise Draining(f"push to session {sid}")
        if session.quarantined is not None:
            raise SessionQuarantined(sid, session.quarantined,
                                     session.strikes)
        with self.trace.span("push", sid=sid, bucket=session.bucket.id) as sp:
            if self.faults is not None:
                llr = self.faults.corrupt(llr, sid=sid)
            llr = self._validate_push(session, llr)
            projected = session.ctx.projected_windows(
                session.ctx.incoming_stages(llr))
            if session.inflight + projected > self.queue_depth:
                overshoot = session.inflight + projected - self.queue_depth
                raise Backpressure(
                    f"session {sid}: {session.inflight} windows pending + "
                    f"{projected} in this push > queue_depth="
                    f"{self.queue_depth}; call step() and retry (or split "
                    f"pushes larger than queue_depth chunks)",
                    retry_after_steps=max(1, -(-overshoot // self.slots)))
            sp.set(windows=session.absorb(llr))

    def step(self) -> int:
        """One batched launch per bucket with pending windows, dispatched
        without blocking; results materialize ``depth``
        launches behind the dispatch front (the same double buffering the
        single-stream front-end uses), landing on each session's ready
        queue. Returns the number of windows dispatched. Never raises on
        a failed launch — the retry/degrade machinery absorbs it. (The
        fault injector's ``crash_at_step`` hook runs OUTSIDE that
        machinery: an injected crash propagates, as a real process death
        would.)"""
        if self.faults is not None:
            self.faults.crash("step")
        done = 0
        for bucket in list(self._buckets.values()):
            if not bucket.pinned:
                bucket.breaker.step()         # open -> half_open countdown
        for bucket in list(self._buckets.values()):
            if bucket.queue:
                done += self._launch(bucket)
            elif bucket.inflight:
                # an evacuated (or idle) bucket materializes everything it
                # still has in flight — fully, so its bits land on the
                # sessions BEFORE any later window decoded elsewhere
                self._retire(bucket, 0)
        return done

    def _launch(self, bucket: Bucket) -> int:
        """Dispatch one batched launch: up to ``slots`` windows ->
        (k*C, L, beta) frames, packed into a pinned buffer of the bucket
        and copied to the device without blocking (the ``batch_pack``
        stage). The kernel pads the partial batch to the plan's tile
        multiple internally (ops._pad_frames); that padding is what the
        occupancy metric charges — a full-slot steady state launches whole
        tiles only. Does NOT block: the oldest in-flight launch beyond
        ``depth`` is materialized instead."""
        taken = bucket.take(self.slots)
        if not taken:
            return 0
        t_take = time.perf_counter()
        wait = self.metrics.stage("queue_wait_ms")
        for w in taken:
            wait.record((t_take - w.t_enq) * 1e3)
        with self.trace.span("launch", bucket=bucket.id,
                             windows=len(taken)) as sp:
            with self.trace.span("batch_pack", bucket=bucket.id):
                # every slot holds a full batch: the pool stays at the
                # launches in flight, whatever the batch sizes
                slot = bucket.staging.acquire(
                    self.slots * taken[0].frames.size,
                    self.slots * bucket.chunk_frames
                    * bucket.decode_cfg.spec.f)
                dev = bucket.staging.stage_in(slot,
                                              [w.frames for w in taken])
            t_pack = time.perf_counter()
            self.metrics.stage("batch_pack_ms").record(
                (t_pack - t_take) * 1e3)
            sp.set(frames=int(dev.shape[0]))
            self._dispatch(bucket, dev, slot, taken)
            self.metrics.stage("launch_ms").record(
                (time.perf_counter() - t_pack) * 1e3)
        self._retire(bucket, self.depth)
        return len(taken)

    def _ref_fallback(self, bucket: Bucket, nframes: int):
        """The degraded-mode decoder: same trellis/spec, reference
        backend (bit-identical to the kernels at fp32 bm_dtype; bf16
        buckets degrade to the fp32 reference, which is the BER-gated
        direction). Never consults the fault injector — the fallback is
        the path that must work when the fast path doesn't."""
        ref_cfg = dataclasses.replace(bucket.decode_cfg,
                                      backend="reference", renorm_every=1)
        return self.cache.batch_decoder(ref_cfg, nframes, mesh=bucket.mesh,
                                        device=bucket.device)

    # -- circuit breaker / failover ---------------------------------------
    def _evacuate(self, bucket: Bucket) -> None:
        """Move every session (and queued window) of a tripped bucket to
        its failover bucket — pinned to the reference backend. Window
        geometry is identical (same plan), so the pending
        queue transfers losslessly; the ``evacuated`` counter and an
        ``evacuate`` span record the event. The tripped bucket's in-flight
        launches materialize FIRST — per-session bit order must survive
        the handoff."""
        target = self._failover_bucket(bucket)
        moved = len(bucket.sessions)
        self._retire(bucket, 0)
        with self.trace.span("evacuate", bucket=bucket.id, to=target.id,
                             sessions=moved, windows=len(bucket.queue)):
            for sid in list(bucket.sessions):
                session = self._sessions[sid]
                session.bucket = target
                target.sessions.add(sid)
            bucket.sessions.clear()
            target.queue.extend(bucket.queue)
            bucket.queue.clear()
        self.metrics.bucket(bucket.id).record_fault("evacuated", n=moved)

    def _readmit(self, bucket: Bucket, primary: Bucket) -> None:
        """The half-open probe succeeded: the device is back. Move the
        failover bucket's sessions (and any still-queued windows) back to
        the primary fast path — after materializing the failover's
        in-flight launches (probe included), preserving bit order."""
        self._retire(bucket, 0)
        with self.trace.span("readmit", bucket=primary.id,
                             sessions=len(bucket.sessions)):
            for sid in list(bucket.sessions):
                session = self._sessions[sid]
                session.bucket = primary
                primary.sessions.add(sid)
            bucket.sessions.clear()
            primary.queue.extend(bucket.queue)
            bucket.queue.clear()

    def _probe(self, primary: Bucket, bucket: Bucket, dev, slot, taken,
               B: int) -> bool:
        """Half-open probe: try this failover batch on the primary's
        fast path. Success closes the breaker and re-admits the
        sessions; failure re-opens it (a fresh trip) and the caller
        falls back to the pinned reference path."""
        bm = self.metrics.bucket(primary.id)
        try:
            with self.trace.span("breaker_probe", bucket=primary.id,
                                 frames=B):
                if self.faults is not None:
                    self.faults.launch(primary.id)
                out = self.cache.batch_decoder(primary.decode_cfg, B,
                                               mesh=primary.mesh,
                                               device=primary.device)(dev)
        except Exception as e:                        # noqa: BLE001
            if _is_device_error(e):
                raise                                 # sticky: no recovery
            bm.record_fault("launch_errors", error=repr(e))
            if primary.breaker.record_failure():      # half_open -> open
                bm.record_fault("breaker_trips")
                self.trace.event("breaker_open", bucket=primary.id,
                                 probe_failed=True)
            return False
        bucket.staging.stage_out(slot, out)
        bucket.inflight.append(
            (slot, taken,
             self.trace.begin("inflight", bucket=bucket.id, frames=B,
                              probe=True)))
        if primary.breaker.record_success():          # half_open -> closed
            self.trace.event("breaker_close", bucket=primary.id)
        self._readmit(bucket, primary)
        return True

    def _dispatch(self, bucket: Bucket, dev: torch.Tensor, slot,
                  taken) -> None:
        """Dispatch the batch ``dev`` (on the device; its host copy is
        ``slot``) with deadline/retry/degrade plus circuit breaking
        (class docstring). Always appends exactly one in-flight launch,
        whose bits are copied back into ``slot`` without blocking."""
        B = dev.shape[0]
        bm = self.metrics.bucket(bucket.id)
        if bucket.pinned:
            # failover path: probe the primary when its breaker is ready,
            # otherwise decode on the pinned reference backend. Neither
            # consults the fault injector — the evacuation target is the
            # path that must work when the fast path doesn't (same
            # contract as _ref_fallback).
            primary = bucket.primary
            if primary is not None \
                    and primary.breaker.state == "half_open" \
                    and self._probe(primary, bucket, dev, slot, taken, B):
                return
            with self.trace.span("launch_attempt", bucket=bucket.id,
                                 pinned=True):
                out = self.cache.batch_decoder(bucket.decode_cfg, B,
                                               mesh=bucket.mesh,
                                               device=bucket.device)(dev)
            bucket.staging.stage_out(slot, out)
            bucket.inflight.append(
                (slot, taken,
                 self.trace.begin("inflight", bucket=bucket.id, frames=B,
                                  pinned=True)))
            return
        deadline = self.launch_timeout_s
        tripped = False
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                with self.trace.span("launch_attempt", bucket=bucket.id,
                                     attempt=attempt):
                    if self.faults is not None:
                        self.faults.launch(bucket.id)
                    refresh = (self.faults is not None
                               and self.faults.plan_cache_miss())
                    if refresh:
                        bm.record_fault("cache_refreshes")
                    fn = self.cache.batch_decoder(bucket.decode_cfg, B,
                                                  mesh=bucket.mesh,
                                                  refresh=refresh,
                                                  device=bucket.device)
                    out = fn(dev)
                    if deadline is not None \
                            and time.perf_counter() - t0 > deadline:
                        raise LaunchTimeout(
                            f"bucket {bucket.id}: launch exceeded "
                            f"{deadline * 1e3:.1f} ms deadline")
                bucket.staging.stage_out(slot, out)
                bucket.inflight.append(
                    (slot, taken,
                     self.trace.begin("inflight", bucket=bucket.id,
                                      frames=B)))
                if bucket.breaker.state != "open":
                    # a late success after the breaker tripped mid-retry
                    # must NOT reset `consecutive`: the breaker stays
                    # open (only the half-open probe closes it), and its
                    # snapshot should keep reporting the streak that
                    # tripped it, not a misleading 0
                    bucket.breaker.record_success()
                if tripped:           # late success on an open breaker:
                    self._evacuate(bucket)   # still fail over — the
                return                       # probe path re-admits
            except LaunchTimeout as e:
                bm.record_fault("timeouts", error=str(e))
            except Exception as e:                    # noqa: BLE001
                if _is_device_error(e):
                    raise                             # sticky: no recovery
                bm.record_fault("launch_errors", error=repr(e))
            if bucket.breaker.record_failure():
                # consecutive failures crossed the threshold: the trip is
                # recorded now, but the remaining retry budget still runs
                # — a degraded window's accounting stays uniform
                # (max_retries+1 attempts, max_retries retries) and a
                # late success still lands the batch on the fast path
                tripped = True
                bm.record_fault("breaker_trips")
                self.trace.event("breaker_open", bucket=bucket.id,
                                 consecutive=bucket.breaker.consecutive)
            if attempt < self.max_retries:
                bm.record_fault("retries")
                self.trace.event("retry", bucket=bucket.id, attempt=attempt)
                if self.backoff_s:
                    time.sleep(self.backoff_s * (2 ** attempt))
        # retries exhausted (or breaker tripped): degrade to the reference
        # fallback so healthy sessions still get (correct) bits — never
        # drop the batch
        bm.record_fault("degraded")
        with self.trace.span("degrade", bucket=bucket.id, frames=B):
            out = self._ref_fallback(bucket, B)(dev)
        bucket.staging.stage_out(slot, out)
        bucket.inflight.append(
            (slot, taken,
             self.trace.begin("inflight", bucket=bucket.id, frames=B,
                              degraded=True)))
        if tripped or bucket.breaker.state != "closed":
            self._evacuate(bucket)

    def _retire(self, bucket: Bucket, leave: int) -> int:
        """Materialize in-flight launches down to ``leave`` (waits on the
        OLDEST launch's event only), distribute bits to sessions, record
        metrics. An error surfacing here is a CUDA error, which is sticky:
        it propagates (the JAX package re-decodes such a launch on its
        reference fallback)."""
        C, f = bucket.chunk_frames, bucket.decode_cfg.spec.f
        bm = self.metrics.bucket(bucket.id)
        deadline = self.launch_timeout_s
        done = 0
        while len(bucket.inflight) > leave:
            slot, taken, inflight_span = bucket.inflight.popleft()
            t0 = time.perf_counter()
            with self.trace.span("retire", bucket=bucket.id,
                                 windows=len(taken)):
                bits = bucket.staging.read(
                    slot, len(taken) * C * f).reshape(-1, f)   # (k*C, f)
                t_done = time.perf_counter()
                inflight_span.end()
                self.metrics.stage("retire_ms").record((t_done - t0) * 1e3)
                if deadline is not None and t_done - t0 > deadline:
                    # cooperative deadline: a hang shows up here; record it
                    # (the NEXT launch's retry path is where recovery
                    # happens)
                    bm.record_fault(
                        "timeouts",
                        error=f"bucket {bucket.id}: materialize "
                              f"took {(t_done - t0) * 1e3:.1f} ms")
                n_bits = live = 0
                for i, w in enumerate(taken):
                    out = bits[i * C:(i + 1) * C].reshape(-1)[:w.n_bits]
                    w.session.ready.append(out.astype(np.int32, copy=False))
                    n_bits += w.n_bits
                    live += min(C, -(-w.n_bits // f))   # real frames only
                B = len(taken) * C
                bm.record_launch(
                    live_frames=live,                   # zero tail frames
                    pad_frames=B - live + bucket.tile_pad(B),  # as pad
                    windows=len(taken), bits=n_bits,
                    window_latency_ms=[(t_done - w.t_enq) * 1e3
                                       for w in taken])
            done += len(taken)
        return done

    def drain(self, checkpoint: str | None = None, *,
              stop: bool = False) -> int:
        """Dispatch until no bucket has pending windows, then materialize
        every in-flight launch. With ``checkpoint=path`` (or
        ``stop=True``) this is the operational stop-the-world handoff:
        admission and pushes are refused FIRST (``Draining``), the
        pipeline retires completely, and the quiesced server is
        snapshotted — restart elsewhere with ``DecodeServer.restore``."""
        if checkpoint is not None or stop:
            self._draining = True
        done = 0
        while any(b.queue for b in self._buckets.values()):
            done += self.step()
        for bucket in self._buckets.values():
            self._retire(bucket, 0)
        if checkpoint is not None:
            self.checkpoint(checkpoint)
        return done

    def checkpoint(self, path: str) -> str:
        """Write an atomic, CRC-validated snapshot of the whole server to
        ``path`` (serve/checkpoint.py). In-flight launches are retired
        first — the snapshot is a consistent cut; sessions resume
        bit-identically after ``restore``."""
        from .checkpoint import save_checkpoint
        return save_checkpoint(self, path)

    @classmethod
    def restore(cls, path: str, *, mesh=None, cache=None, faults=None,
                trace=None, device=None) -> "DecodeServer":
        """Rebuild a server from a checkpoint in a fresh process (a
        checkpoint of either package). The process-local collaborators
        (mesh/cache/faults/trace/device) are passed anew — they are not
        serializable state. Raises ``CheckpointError`` on a corrupt,
        truncated, or version-mismatched file; never returns a
        half-loaded server."""
        from .checkpoint import restore_server
        return restore_server(cls, path, mesh=mesh, cache=cache,
                              faults=faults, trace=trace, device=device)

    def poll(self, sid: int) -> np.ndarray:
        """Collect (and clear) a session's bits materialized so far —
        non-blocking; results trail the dispatch front by up to ``depth``
        launches (drain()/close_session force completion). A quarantined
        session raises its structured ``SessionQuarantined`` error
        instead — use ``close_session`` to tear it down and recover any
        bits decoded before quarantine."""
        session = self._session(sid)
        if session.quarantined is not None:
            raise SessionQuarantined(sid, session.quarantined,
                                     session.strikes)
        return session.take_ready()

    def close_session(self, sid: int) -> np.ndarray:
        """Flush the session's tail, decode everything it still has
        pending, free its slot, and return the remaining bits. Works on
        quarantined sessions too (teardown must never be refused)."""
        session = self._session(sid)
        session.finish()
        while session.inflight:
            self._launch(session.bucket)
        self._retire(session.bucket, 0)
        session.closed = True
        session.bucket.sessions.discard(sid)
        # an evacuated (or re-admitted) session may still have launches in
        # flight on its partner bucket — retire those too before teardown
        partner = (session.bucket.primary if session.bucket.pinned
                   else self._buckets.get(session.bucket.key + ("failover",)))
        if partner is not None:
            self._retire(partner, 0)
        del self._sessions[sid]
        return session.take_ready()

    def session_state(self, sid: int) -> dict:
        """Structured per-session health (JSON-ready): strikes,
        quarantine reason, pending windows, sanitizer counters."""
        s = self._session(sid)
        return {"sid": sid, "bucket": s.bucket.id, "strikes": s.strikes,
                "quarantined": s.quarantined, "inflight": s.inflight,
                **s.ctx.numeric_stats()}

    # -- introspection ----------------------------------------------------
    def buckets(self) -> list[Bucket]:
        return list(self._buckets.values())

    def metrics_snapshot(self) -> dict:
        """Per-bucket rows + totals + stage-latency breakdowns +
        plan-cache stats, JSON-ready (the shape the JAX benchmarks' 'serve'
        section records). Totals carry the fault counters, derived
        throughput (``mbps``/``uptime_s``) and overall health;
        ``stages`` holds the queue-wait/pack/launch/retire latency
        summaries; ``quarantined_sessions`` counts live quarantined
        sessions; ``breakers`` carries every primary bucket's circuit
        breaker (state/trips/consecutive); ``checkpoint`` the save/
        restore counts; ``faults`` reports the injector's schedule
        counters when one is attached. ``stages_hist`` carries the same
        stage histograms at full bucket resolution (Prometheus histogram
        shape — cumulative ``[le, count]`` pairs), so a scrape exports
        aggregatable ``_bucket`` series, not just point summaries."""
        snap = {"buckets": self.metrics.snapshot(),
                "totals": self.metrics.totals(),
                "stages": self.metrics.stage_snapshot(),
                "stages_hist": self.metrics.stage_histograms(),
                "plan_cache": self.cache.stats(),
                "sessions": len(self._sessions),
                "quarantined_sessions": sum(
                    1 for s in self._sessions.values()
                    if s.quarantined is not None),
                "breakers": {b.id: b.breaker.snapshot()
                             for b in self._buckets.values()
                             if not b.pinned},
                "checkpoint": {"saves": self.checkpoint_saves,
                               "restores": self.checkpoint_restores},
                "draining": self._draining}
        if self.faults is not None:
            snap["faults"] = self.faults.stats()
        return snap
