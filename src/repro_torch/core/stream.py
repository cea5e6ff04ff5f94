"""Streaming decode front end: unbounded LLR streams, chunk by chunk; port
of ``repro.core.stream``.

``make_decoder`` is single-shot: it wants the whole stream in memory. A
receiver does not work like that — samples arrive forever. This module
chunks an unbounded (n, beta) LLR stream into frame batches, keeps the
v1/v2 overlap context across chunk boundaries (so the chunked decode is
BIT-IDENTICAL to the single-shot framed decode of the same stream), and
double-buffers the per-chunk launches.

The per-session state — the rolling v1/v2 overlap buffer, the
stream-global depuncture phase, and the chunk/flush window extraction —
lives in ``StreamContext`` (numpy, copied from the JAX package: the same
windows, and ``state_dict`` v1 and v2 load in either package), so the
multi-tenant serve layer (repro_torch.serve) can run one context per
session and batch the windows of many sessions into one kernel launch.
``StreamDecoder`` is the single-session composition: one context plus the
double-buffered dispatch front.

Double buffering without JAX's asynchronous runtime. A chunk's window is
copied into a pinned host buffer (``StagingPool``), copied to the card
with ``non_blocking=True``, decoded by the unified kernel on the current
stream, and its bits are copied back, again without blocking, into a
pinned output; one CUDA event is recorded per chunk. Nothing on that path
synchronises. ``_drain`` waits on the OLDEST chunk's event only, so the
host frames chunk i+1 while the card decodes chunk i. A staging buffer
goes back to the pool only after its chunk's event has completed and its
bits were read, so a buffer is never rewritten under a copy. Everything
runs on the current stream, where the kernel wrappers launch.

Geometry: a chunk covers ``chunk_frames * spec.f`` kept stages; the decode
window around it is ``[start - v1, end + v2)``, framed on the card with
``unfold`` (serve.plan_cache.build_window_fn). The flush pads the final
partial chunk with zero LLRs (neutral, exactly like frame_llr's edge
padding), and the stream start is zero-padded the same way — hence the
bit-exact equivalence with ``make_decoder``. Punctured rates are
depunctured inside ``push``: callers feed the raw punctured symbol stream
in arbitrary slices.

The default chunk comes from ``kernels.autotune.plan_decode``: two tiles
per device, as in the JAX package. Window decoders are built once per
(trellis, spec, plan, nframes, device) in the process-global plan cache
(serve.plan_cache).

Device. ``make_stream_decoder``, ``StreamDecoder`` and ``stream_decode``
take ``device=None``, which means ``"cuda"``; without a card they raise
unless ``device="cpu"`` is given, where the same calls run synchronously
through the kernels' plain versions. With ``mesh=`` (a
``distributed.FrameMesh``) each chunk's window is staged and framed on the
mesh's home device and its frames are decoded across the mesh's devices
(distributed/stream.py); ``device`` is then the home device. There is
still one staging slot and one event per chunk, recorded on the home
device's stream after it has waited on every shard.
"""
from __future__ import annotations

import base64
import collections
import dataclasses
import time
import zlib

import numpy as np
import torch

from .pipeline import DecoderConfig
from .puncture import PATTERNS
from .sanitize import LLR_CLIP, sanitize_llr

__all__ = ["StreamContext", "StreamDecoder", "Window", "StagingPool",
           "make_stream_decoder", "stream_decode", "STATE_VERSIONS"]

#: ``StreamContext.state_dict`` schema versions this build can write AND
#: read back. v1 stores the carry arrays as plain JSON lists (readable,
#: large); v2 stores them as base64 little-endian float32 bytes with a
#: CRC over the binary payload. Both round-trip bit-exactly, and both are
#: the JAX package's byte for byte.
STATE_VERSIONS = (1, 2)


def _enc_f32(arr: np.ndarray) -> str:
    """float32 array -> base64 of its little-endian bytes (bit-exact)."""
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype="<f4").tobytes()).decode("ascii")


def _dec_f32(data: str, shape: tuple) -> np.ndarray:
    raw = base64.b64decode(data.encode("ascii"), validate=True)
    arr = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    return arr.reshape(shape)


@dataclasses.dataclass(frozen=True)
class Window:
    """One extracted decode window: ``window`` spans
    ``[chunk_start - v1, chunk_end + v2)`` stages; decoding it yields
    ``nframes * f`` bits of which the first ``n_bits`` are real (the rest
    is flush padding)."""
    window: np.ndarray        # (v1 + nframes*f + v2, beta) float32
    nframes: int
    n_bits: int

    def frames(self, spec) -> np.ndarray:
        """Frame the window host-side: (nframes, L, beta). Pure gather —
        identical values to the on-device ``unfold`` framing, so a batch
        built from these frames decodes bit-identically."""
        starts = np.arange(self.nframes) * spec.f
        idx = starts[:, None] + np.arange(spec.frame_len)[None, :]
        return self.window[idx]


class StreamContext:
    """Per-session chunking state, extracted from StreamDecoder so the
    serve layer can batch windows across sessions.

    Holds the rolling overlap buffer (always retaining the v1 left
    context of the next chunk), the pushed/emitted stage counters, and —
    for punctured rates — the raw-symbol remainder plus the stream-global
    pattern phase. ``append`` absorbs raw input; ``take_windows`` yields
    every complete chunk window; ``flush_window`` zero-pads and yields the
    final partial chunk (or None if nothing is pending).

    The context is also the stream's numeric-robustness carry: every
    ``append`` validates the push shape and (``sanitize='zero'``, the
    default) scrubs NaN/Inf to neutral zero LLRs and clamps |llr| >
    ``llr_clip`` — bit-identical on clean inputs, with the cumulative
    scrub count in ``n_sanitized``/``numeric_stats()``. Per-stage
    path-metric renormalization inside each window's forward pass
    (DecoderConfig.renorm_every) plus this input clamp is what keeps an
    UNBOUNDED stream's metrics bounded in fp32/bf16 no matter how long
    the session lives. ``sanitize='raise'`` rejects poisoned pushes
    instead (the serve layer's strict-tenant policy); ``'off'`` skips the
    scan (the serve layer pre-sanitizes at its own boundary).
    """

    def __init__(self, spec, beta: int, chunk_frames: int, rate: str = "1/2",
                 *, sanitize: str = "zero", llr_clip: float = LLR_CLIP):
        assert chunk_frames > 0
        self.spec = spec
        self.beta = beta
        self.chunk_frames = chunk_frames
        self.rate = rate
        self.sanitize = sanitize
        self.llr_clip = llr_clip
        self.reset()

    def reset(self):
        # the buffer holds [next_chunk_start - v1, ...); the stream start
        # gets the same zero left-context frame_llr would pad with
        self._buf = np.zeros((self.spec.v1, self.beta), np.float32)
        self._raw = np.zeros((0,), np.float32)  # punctured symbols pending
        self._phase = 0                         # stages depunctured so far
        self.n_in = 0                           # stages appended
        self.n_out = 0                          # bits covered by windows
        self.n_sanitized = 0                    # poisoned values scrubbed

    def check_shape(self, llr: np.ndarray) -> None:
        """Reject structurally invalid pushes with a clear error (the raw
        reshape inside ``append`` would raise something cryptic)."""
        if llr.ndim > 2:
            raise ValueError(
                f"push must be flat or (m, beta); got shape {llr.shape}")
        if self.rate == "1/2" and llr.size % self.beta != 0:
            raise ValueError(
                f"rate-1/2 push of {llr.size} values is not a multiple of "
                f"beta={self.beta} soft symbols per stage")
        if llr.ndim == 2 and llr.shape[1] != self.beta:
            raise ValueError(
                f"2-D push must have beta={self.beta} columns; "
                f"got shape {llr.shape}")

    def numeric_stats(self) -> dict:
        """Cumulative numeric-hardening counters for this stream."""
        return {"stages_in": self.n_in, "bits_out": self.n_out,
                "sanitized_values": self.n_sanitized}

    # -- durable sessions: versioned carry-state serialization -------------
    def _geometry(self) -> dict:
        """The identity a saved state must match to be loadable: a state
        restored into a context of different frame geometry would decode
        different bits, so the mismatch is an error, never a best-effort
        load."""
        return {"f": self.spec.f, "v1": self.spec.v1, "v2": self.spec.v2,
                "beta": self.beta, "chunk_frames": self.chunk_frames,
                "rate": self.rate}

    def state_dict(self, version: int = 2) -> dict:
        """The session's complete carry state, JSON-ready and versioned.

        This is everything a fresh process needs to resume the stream
        BIT-IDENTICALLY: the rolling v1/v2 overlap buffer, the pending
        raw punctured tail, the stream-global depuncture phase, and the
        pushed/emitted/sanitized counters. The truncated-traceback
        insight (arXiv 1608.00066) is why this works and why it is
        small: frame m's decode depends only on the window
        ``[m*f - v1, (m+1)*f + v2)``, so a bounded carry window is all
        the state a session ever needs — ``load_state`` + replaying the
        not-yet-pushed input reproduces the uninterrupted stream's
        output exactly (tests/test_torch_checkpoint.py gates the bit
        identity)."""
        if version not in STATE_VERSIONS:
            raise ValueError(f"unknown StreamContext state version "
                             f"{version}; this build writes {STATE_VERSIONS}")
        state = {"version": version, "geometry": self._geometry(),
                 "phase": int(self._phase), "n_in": int(self.n_in),
                 "n_out": int(self.n_out),
                 "n_sanitized": int(self.n_sanitized),
                 "buf_rows": int(self._buf.shape[0]),
                 "raw_len": int(self._raw.shape[0])}
        if version == 1:
            state["buf"] = [float(x) for x in self._buf.reshape(-1)]
            state["raw"] = [float(x) for x in self._raw]
        else:
            buf_b64 = _enc_f32(self._buf)
            raw_b64 = _enc_f32(self._raw)
            state["buf"] = buf_b64
            state["raw"] = raw_b64
            state["crc"] = zlib.crc32(
                (buf_b64 + "|" + raw_b64).encode("ascii"))
        return state

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` into this context (which must have
        the same geometry). Validates version, geometry, and — for v2
        states — the carry CRC before touching any field, so a corrupt
        or mismatched state never half-loads."""
        try:
            version = state["version"]
            geometry = state["geometry"]
        except (TypeError, KeyError) as e:
            raise ValueError(
                f"not a StreamContext state dict (missing {e})") from None
        if version not in STATE_VERSIONS:
            raise ValueError(
                f"unsupported StreamContext state version {version!r}; "
                f"this build reads {STATE_VERSIONS}")
        if geometry != self._geometry():
            raise ValueError(
                f"state geometry {geometry} does not match this context's "
                f"{self._geometry()}; restoring it would decode different "
                f"bits")
        buf_rows, raw_len = int(state["buf_rows"]), int(state["raw_len"])
        if version == 1:
            buf = np.asarray(state["buf"], np.float32).reshape(
                buf_rows, self.beta)
            raw = np.asarray(state["raw"], np.float32).reshape(raw_len)
        else:
            crc = zlib.crc32(
                (state["buf"] + "|" + state["raw"]).encode("ascii"))
            if crc != state.get("crc"):
                raise ValueError(
                    f"StreamContext state CRC mismatch (stored "
                    f"{state.get('crc')}, computed {crc}): the carry "
                    f"buffers are corrupt")
            try:
                buf = _dec_f32(state["buf"], (buf_rows, self.beta))
                raw = _dec_f32(state["raw"], (raw_len,))
            except ValueError as e:
                raise ValueError(
                    f"StreamContext carry buffers undecodable: {e}") \
                    from None
        # all fields validated — commit atomically
        self._buf = buf
        self._raw = raw
        self._phase = int(state["phase"])
        self.n_in = int(state["n_in"])
        self.n_out = int(state["n_out"])
        self.n_sanitized = int(state["n_sanitized"])

    # -- depuncturing (stream-global phase) -------------------------------
    def _stage_counts(self, t_max: int) -> np.ndarray:
        """Kept symbols per stage for the next ``t_max`` stages (cyclic in
        the pattern period, offset by the stream-global phase)."""
        pat = PATTERNS[self.rate]
        per_stage = pat.sum(axis=0)             # kept symbols at phase t
        return per_stage[(self._phase + np.arange(t_max)) % pat.shape[1]]

    def _depuncture(self, final: bool) -> np.ndarray:
        """Convert buffered raw symbols into complete (s, beta) stages.

        Bit-identical to one-shot ``puncture.depuncture`` of the whole
        stream: punctured positions become neutral zero LLRs. ``final``
        also emits a trailing stage the remainder only partly fills
        (missing kept symbols become zeros — an erased tail)."""
        pat = PATTERNS[self.rate]
        period = pat.shape[1]
        r = self._raw.shape[0]
        if r == 0:
            return np.zeros((0, self.beta), np.float32)
        t_max = r + period                       # >= any reachable stage count
        cum = np.cumsum(self._stage_counts(t_max))
        s = int(np.searchsorted(cum, r, side="right"))
        if final and (s == 0 or cum[s - 1] < r):
            s += 1                               # partial last stage
        if s == 0:
            return np.zeros((0, self.beta), np.float32)
        used = int(min(cum[s - 1], r))
        p0 = self._phase % period
        mask = np.tile(pat, (1, -(-(p0 + s) // period))).T[p0:p0 + s]
        flat = np.zeros((s * self.beta,), np.float32)
        flat[np.flatnonzero(mask.reshape(-1))[:used]] = self._raw[:used]
        self._raw = self._raw[used:]
        self._phase += s
        return flat.reshape(s, self.beta)

    # -- input / window extraction ----------------------------------------
    def append(self, llr) -> int:
        """Absorb raw input; returns the number of stages added.

        rate 1/2: (m, beta) or flat (m*beta,) soft symbols.
        punctured: the raw punctured symbol stream, flat, any slice size —
        the pattern alignment is tracked here, stream-globally."""
        llr = np.asarray(llr, np.float32)
        self.check_shape(llr)
        if self.sanitize != "off":
            llr, n_bad = sanitize_llr(llr, self.llr_clip, self.sanitize)
            self.n_sanitized += n_bad
        if self.rate != "1/2":
            self._raw = np.concatenate([self._raw, llr.reshape(-1)])
            staged = self._depuncture(final=False)
        else:
            staged = llr.reshape(-1, self.beta)
        if staged.size:
            self._buf = np.concatenate([self._buf, staged])
            self.n_in += staged.shape[0]
        return staged.shape[0]

    def incoming_stages(self, llr) -> int:
        """Stages ``append(llr)`` would add — exact, including the
        punctured-rate phase and raw remainder (the serve layer's
        backpressure check runs BEFORE absorbing anything)."""
        llr = np.asarray(llr)
        if self.rate == "1/2":
            return llr.size // self.beta
        r = self._raw.shape[0] + llr.size
        if r == 0:
            return 0
        cum = np.cumsum(self._stage_counts(r + PATTERNS[self.rate].shape[1]))
        return int(np.searchsorted(cum, r, side="right"))

    def projected_windows(self, add_stages: int) -> int:
        """Complete chunk windows extractable once ``add_stages`` more
        stages arrive (counting what is already buffered)."""
        buf_after = self._buf.shape[0] + add_stages
        return max(0, (buf_after - self.spec.v1 - self.spec.v2)
                   // (self.chunk_frames * self.spec.f))

    def take_windows(self) -> list[Window]:
        """Every complete chunk window currently extractable."""
        spec, C = self.spec, self.chunk_frames
        ck = C * spec.f                          # kept stages per chunk
        need = spec.v1 + ck + spec.v2            # full decode window
        out = []
        while self._buf.shape[0] >= need:
            out.append(Window(self._buf[:need], C, ck))
            self._buf = self._buf[ck:]           # keep next chunk's v1 lead
            self.n_out += ck
        return out

    def _stage_raw_tail(self):
        """Flush-time prelude: convert any leftover raw punctured symbols
        (including a partly-filled final stage) into buffered stages."""
        if self.rate != "1/2" and self._raw.size:
            staged = self._depuncture(final=True)
            if staged.size:
                self._buf = np.concatenate([self._buf, staged])
                self.n_in += staged.shape[0]

    def flush_window(self) -> Window | None:
        """The zero-padded final partial chunk (frame_llr's edge padding)
        as ONE window of ceil(tail/f) frames — possibly more than
        ``chunk_frames`` when the last chunk was only missing its v2
        right context. None when every pushed stage is already covered.
        Resets nothing — call ``reset`` to reuse the context."""
        self._stage_raw_tail()
        spec = self.spec
        tail = self.n_in - self.n_out            # stages not yet windowed
        if tail <= 0:
            return None
        nframes = -(-tail // spec.f)
        need = spec.v1 + nframes * spec.f + spec.v2
        window = self._buf
        if window.shape[0] < need:
            pad = np.zeros((need - window.shape[0], self.beta), np.float32)
            window = np.concatenate([window, pad])
        self.n_out += tail
        return Window(window[:need], nframes, tail)

    def flush_chunks(self) -> list[Window]:
        """Flush for the serve layer: the tail as a SEQUENCE of full
        ``chunk_frames`` windows (zero-padded at the stream end), each
        carrying its share of ``n_bits`` — so a bucket keeps its one
        window geometry no matter how long the tail is (it can exceed one
        chunk by up to v2-1 stages of missing right context). The windows
        decode bit-identically to flush_window's single window: frame m's
        decode region depends only on the zero-extended stream."""
        self._stage_raw_tail()
        spec, C = self.spec, self.chunk_frames
        tail = self.n_in - self.n_out
        if tail <= 0:
            return []
        ck = C * spec.f
        nwin = -(-tail // ck)
        need = spec.v1 + nwin * ck + spec.v2
        if self._buf.shape[0] < need:
            pad = np.zeros((need - self._buf.shape[0], self.beta),
                           np.float32)
            self._buf = np.concatenate([self._buf, pad])
        out = []
        for _ in range(nwin):
            n_bits = min(ck, tail)
            out.append(Window(self._buf[:spec.v1 + ck + spec.v2], C, n_bits))
            self._buf = self._buf[ck:]
            tail -= n_bits
            self.n_out += n_bits
        return out


class _Slot:
    """One chunk's pinned host pair: the window (or batch) going in, the
    bits coming out, and the event recorded after its last copy."""
    __slots__ = ("inp", "out", "event")

    def __init__(self, n_in: int, n_out: int, cuda: bool):
        self.inp = torch.empty((n_in,), dtype=torch.float32, pin_memory=cuda)
        self.out = torch.empty((n_out,), dtype=torch.int32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None


class StagingPool:
    """Host staging buffers for the launches in flight on ``device``.

    On a CUDA device the buffers are pinned, so both copies are
    asynchronous, and each slot carries the event recorded after its
    launch's copy back. ``acquire`` hands out a free slot (or allocates one
    the first time a size is needed); a slot returns to the pool only
    through ``read``, after its event completed and its bits were copied
    out. A free slot too small for a request is dropped when a larger one
    is allocated, so the pool holds no more slots than were ever in flight
    at once. On the CPU the same calls run synchronously and there is no
    event.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._free: list[_Slot] = []

    def acquire(self, n_in: int, n_out: int) -> _Slot:
        for i, slot in enumerate(self._free):
            if slot.inp.numel() >= n_in and slot.out.numel() >= n_out:
                return self._free.pop(i)
        if self._free:
            self._free.pop(0)                   # replaced by a larger one
        return _Slot(n_in, n_out, self.cuda)

    def stage_in(self, slot: _Slot, parts) -> torch.Tensor:
        """Concatenate the host arrays ``parts`` (along axis 0) into the
        slot and start their copy to the device; returns the device
        tensor. Does not block."""
        shape = (sum(p.shape[0] for p in parts),) + parts[0].shape[1:]
        host = slot.inp[:int(np.prod(shape))].view(shape)
        np.concatenate(parts, out=host.numpy())
        return host.to(self.device, non_blocking=True)

    def stage_out(self, slot: _Slot, bits: torch.Tensor) -> None:
        """Start the copy of ``bits`` back into the slot and record the
        slot's event after it. Does not block."""
        flat = bits.reshape(-1)
        slot.out[:flat.numel()].copy_(flat, non_blocking=True)
        if slot.event is not None:
            slot.event.record(torch.cuda.current_stream(self.device))

    def read(self, slot: _Slot, n: int) -> np.ndarray:
        """Wait for the slot's event, copy its first ``n`` bits out and
        return the slot to the pool."""
        if slot.event is not None:
            slot.event.synchronize()
        out = slot.out[:n].numpy().copy()
        self._free.append(slot)
        return out


def _host_array(x) -> np.ndarray:
    """Host float32 view of a push (numpy, list, or a tensor anywhere)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class StreamDecoder:
    """Incremental decoder: ``push`` LLR samples, collect decoded bits.

    push() returns the bits whose chunks have *completed* (possibly an
    empty array — results trail the dispatch front by ``depth`` chunks);
    flush() decodes the zero-padded tail and drains everything pending.
    The instance is reusable after flush(). Feed (m, beta) soft symbols,
    or — for punctured rates — the raw punctured symbol stream (the
    context depunctures in-stream; see StreamContext). Bits come back as
    host numpy int32 arrays.

    ``host_ms()`` reports where the host's time went, per phase: framing
    (the context's append/window extraction), copy_in (into the pinned
    buffer, and the copy to the card started), dispatch (the launch and
    the copy back started) and drain (waiting on the oldest event and
    copying its bits out).
    """

    def __init__(self, cfg: DecoderConfig, chunk_frames: int, *,
                 depth: int = 1, mesh=None, decode_frames=None, cache=None,
                 faults=None, sanitize: str = "zero", trace=None,
                 device=None):
        from ..serve.plan_cache import resolve_placement
        assert chunk_frames > 0 and depth >= 0
        mesh, self.device = resolve_placement(mesh, device)
        self.cfg = cfg
        self.spec = cfg.spec
        self.beta = cfg.trellis.beta
        self.chunk_frames = chunk_frames
        self.depth = depth                      # chunks left in flight
        self.mesh = mesh
        self._decode_frames = decode_frames     # explicit override only
        self._local_fns = {}                    # override path: per-instance
        if cache is None:
            from ..serve.plan_cache import PLAN_CACHE as cache
        self._cache = cache
        # tracing hook (repro_torch.obs): chunk dispatches become sync spans
        # and each in-flight chunk an ASYNC span from dispatch to drain
        if trace is None:
            from ..obs.tracer import get_tracer
            trace = get_tracer()
        self.trace = trace
        # fault-injection hook — None in production. The single-stream
        # front end has no retry machinery: an injected launch fault
        # propagates to the caller (the server is the layer that retries)
        self._faults = faults
        self._ctx = StreamContext(cfg.spec, self.beta, chunk_frames,
                                  cfg.rate, sanitize=sanitize)
        self._staging = StagingPool(self.device)
        self._inflight = collections.deque()    # (slot, n_bits, span)
        self._host = dict.fromkeys(("framing", "copy_in", "dispatch",
                                    "drain"), 0.0)
        self.chunks = 0                         # windows dispatched

    def _window_decoder(self, nframes: int):
        """Window -> bits for a chunk of ``nframes`` frames, from the
        process-global plan cache (one program per (cfg, nframes,
        device)). An explicit decode_frames override has no cacheable
        identity, so it is memoized per instance instead."""
        if self._decode_frames is not None:
            fn = self._local_fns.get(nframes)
            if fn is None:
                from ..serve.plan_cache import build_window_fn
                fn = build_window_fn(self.cfg.spec, self._decode_frames,
                                     nframes)
                self._local_fns[nframes] = fn
            return fn
        return self._cache.window_decoder(self.cfg, nframes, mesh=self.mesh,
                                          device=self.device)

    def _dispatch(self, w: Window):
        """Stage, launch and start the copy back of one window; never
        blocks."""
        with self.trace.span("dispatch", nframes=w.nframes,
                             n_bits=w.n_bits):
            if self._faults is not None:
                self._faults.launch("stream")
            t0 = time.perf_counter()
            slot = self._staging.acquire(w.window.size,
                                         w.nframes * self.spec.f)
            window = self._staging.stage_in(slot, [w.window])
            t1 = time.perf_counter()
            bits = self._window_decoder(w.nframes)(window)
            self._staging.stage_out(slot, bits)
            t2 = time.perf_counter()
        self._host["copy_in"] += t1 - t0
        self._host["dispatch"] += t2 - t1
        self.chunks += 1
        # async span: dispatch -> drain; overlapping chunk spans ARE the
        # double buffering, rendered as overlap by the Chrome exporter
        self._inflight.append(
            (slot, w.n_bits,
             self.trace.begin("chunk", nframes=w.nframes, n_bits=w.n_bits)))

    def _drain(self, leave: int) -> list[np.ndarray]:
        out = []
        t0 = time.perf_counter()
        while len(self._inflight) > leave:
            slot, n_bits, chunk_span = self._inflight.popleft()
            out.append(self._staging.read(slot, n_bits))   # OLDEST only
            chunk_span.end()
        self._host["drain"] += time.perf_counter() - t0
        return out

    def push(self, llr) -> np.ndarray:
        """Feed soft symbols; returns the decoded bits of every chunk that
        has completed so far. The context validates the push shape and
        sanitizes NaN/Inf/out-of-range values (see StreamContext)."""
        with self.trace.span("push"):
            if self._faults is not None:
                llr = self._faults.corrupt(llr)
            t0 = time.perf_counter()
            self._ctx.append(_host_array(llr))
            windows = self._ctx.take_windows()
            self._host["framing"] += time.perf_counter() - t0
            out = []
            for w in windows:
                self._dispatch(w)
                out.extend(self._drain(self.depth))
        return (np.concatenate(out) if out
                else np.zeros((0,), np.int32))

    def flush(self) -> np.ndarray:
        """Decode the zero-padded tail, drain all in-flight chunks, and
        reset for the next stream. Returns the remaining decoded bits."""
        with self.trace.span("flush"):
            t0 = time.perf_counter()
            w = self._ctx.flush_window()
            self._host["framing"] += time.perf_counter() - t0
            if w is not None:
                self._dispatch(w)
            out = self._drain(0)
            self._ctx.reset()
        return (np.concatenate(out) if out
                else np.zeros((0,), np.int32))

    def numeric_stats(self) -> dict:
        """The context's cumulative numeric-hardening counters."""
        return self._ctx.numeric_stats()

    def host_ms(self) -> dict:
        """Host milliseconds by phase since construction, and ``chunks``
        dispatched (see the class docstring)."""
        return {**{k: v * 1e3 for k, v in self._host.items()},
                "chunks": self.chunks}


def make_stream_decoder(cfg: DecoderConfig, *, chunk_frames: int | None = None,
                        mesh=None, depth: int = 1, cache=None, faults=None,
                        trace=None, device=None) -> StreamDecoder:
    """Build a StreamDecoder for ``cfg`` on ``device`` (``None`` =
    ``"cuda"``).

    chunk_frames: frames per chunk; default comes from
      kernels.autotune.plan_decode — two kernel tiles per device.
    mesh: optional distributed.FrameMesh; each chunk's frames are then
      decoded across the mesh's devices and the default chunk is two tiles
      per device (``device`` must be None or the mesh's home device).
    depth: chunks allowed in flight behind the dispatch front (1 = classic
      double buffering; 0 = synchronous, for debugging).
    cache: plan cache override (default: the process-global PLAN_CACHE).
    faults: optional repro_torch.testing.faults.FaultInjector.
    trace: optional repro_torch.obs.Tracer (None = the process-global
      tracer, a no-op unless one was set).
    """
    from ..serve.plan_cache import resolve_placement
    mesh, device = resolve_placement(mesh, device)
    if chunk_frames is None:
        from ..kernels.autotune import plan_decode
        plan = plan_decode(
            cfg.trellis, cfg.spec, unified=cfg.backend != "kernel_split",
            pack_survivors=cfg.pack_survivors, radix=cfg.radix,
            bm_dtype=cfg.bm_dtype, layout=cfg.layout,
            num_devices=mesh.size if mesh is not None else 1,
            block_frames=cfg.block_frames, overlap=cfg.overlap,
            device=device)
        chunk_frames = plan.chunk_frames
    return StreamDecoder(cfg, chunk_frames, depth=depth, mesh=mesh,
                         cache=cache, faults=faults, trace=trace,
                         device=device)


def stream_decode(cfg: DecoderConfig, llr, n: int | None = None, *,
                  chunk_frames: int | None = None, mesh=None,
                  push_size: int | None = None, device=None) -> np.ndarray:
    """Convenience one-call wrapper: stream ``llr`` through a
    StreamDecoder in ``push_size``-sized pushes and return the first n
    bits (host numpy int32) — bit-identical to
    ``make_decoder(cfg)(llr, n)``. Like make_decoder, a punctured-rate cfg
    takes the raw punctured symbol stream (and needs ``n``); it is
    depunctured in-stream (push_size then counts raw symbols)."""
    llr = _host_array(llr)
    if cfg.rate != "1/2":
        if n is None:
            raise ValueError("n is required for punctured rates")
        llr = llr.reshape(-1)                    # raw punctured symbols
    else:
        llr = llr.reshape(-1, cfg.trellis.beta)
    if n is None:
        n = llr.shape[0]
    dec = make_stream_decoder(cfg, chunk_frames=chunk_frames, mesh=mesh,
                              device=device)
    if push_size is None:
        push_size = max(1, dec.chunk_frames) * cfg.spec.f
    parts = [dec.push(llr[i:i + push_size])
             for i in range(0, llr.shape[0], push_size)]
    parts.append(dec.flush())
    return np.concatenate(parts)[:n]
