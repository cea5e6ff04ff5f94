"""Decode-program cache shared by the serve, stream and pipeline layers:
port of ``repro.serve.plan_cache``.

Every layer that decodes frames builds the same two things: a
``decode_frames`` closure dispatching one backend configuration on one
device, and a launcher specialised to a fixed frame count (a stream chunk
window, or a serve bucket's batch). ``PlanCache`` keeps one of each per
identity, so tenant churn (sessions opening and closing all day) never
builds a program twice. Entries are keyed by

    (kind, cfg, nframes, mesh, device)

where a ``DecoderConfig`` is (trellis, spec, plan knobs) and the kernel-knob
part of the key is ``kernels.autotune.DecodePlan.cache_key()``. Three kinds:

  * ``frames``  — the backend-dispatch closure (pipeline layer);
  * ``window``  — chunk window -> bits (stream layer);
  * ``batch``   — (nframes, L, beta) frames -> (nframes, f) bits (serve
                  layer: one bucket launch).

The JAX package caches ``jax.jit`` programs; PyTorch runs eagerly, so here
an entry is a launcher closure over the kernel wrappers, whose CUDA kernels
are built once per process (kernels/build.py). ``stats()`` keeps the JAX
package's keys. ``traces`` counts programs as JAX counts traces: one for
each built window or batch program, when it first runs, so one per
(cfg, nframes, device) no matter how many sessions come and go.

Device. Every entry takes ``device=None``, which means ``"cuda"`` (raises
without a card unless ``device="cpu"``), and ``mesh=None``. With a
``distributed.FrameMesh`` the frame axis is sharded across the mesh's
devices (distributed/stream.py) and the entry's inputs and outputs live on
the mesh's home device; ``device``, if given too, must be that device.
"""
from __future__ import annotations

import threading
import time

from ..core.pipeline import DecoderConfig, _build_frame_decoder
from ..distributed.stream import FrameMesh, normalise_device
from ..kernels.ops import resolve_device
from ..obs.tracer import get_tracer

__all__ = ["PlanCache", "PLAN_CACHE", "build_window_fn", "resolve_placement"]


def resolve_placement(mesh, device):
    """(mesh, device) of an entry point that takes both: without a mesh,
    ``resolve_device(device)``; with one, its home device. A ``device``
    that is not the mesh's home raises ``ValueError``, a ``mesh`` that is
    not a ``FrameMesh`` ``TypeError``."""
    if mesh is None:
        return None, resolve_device(device)
    if not isinstance(mesh, FrameMesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.FrameMesh "
                        f"or None, got {type(mesh).__name__}")
    if device is not None and normalise_device(device) != mesh.home:
        raise ValueError(f"device {device} is not the mesh's home device "
                         f"{mesh.home}")
    return mesh, mesh.home


def _once(hook):
    """A callable that runs ``hook`` on its first call only (None: no-op)."""
    pending = [hook] if hook is not None else []

    def fire():
        if pending:
            pending.pop()()
    return fire


def build_window_fn(spec, decode_frames, nframes: int, trace_hook=None):
    """Window -> bits for a chunk of ``nframes`` frames: frame the
    (v1 + nframes*f + v2, beta) window on its device, decode, flatten.
    ``trace_hook`` (if given) runs on the first call only — the cache uses
    it to count programs, as the JAX package counts traces."""
    L, f = spec.frame_len, spec.f
    need = spec.v1 + nframes * f + spec.v2
    first = _once(trace_hook)

    def run(window):
        first()
        if window.shape[0] != need:
            raise ValueError(f"window of {window.shape[0]} stages, expected "
                             f"{need} (v1 + {nframes} frames x f + v2)")
        # unfold puts the window axis last: (nframes, beta, L)
        frames = window.unfold(0, L, f).transpose(1, 2).contiguous()
        return decode_frames(frames).reshape(-1)

    return run


class PlanCache:
    """Thread-safe registry of decode programs.

    The default instance is the module-global ``PLAN_CACHE``; tests and
    servers that want isolated accounting pass their own.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._fns: dict = {}
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.build_ms = 0.0

    # -- bookkeeping ------------------------------------------------------
    def _get(self, key, build, refresh: bool = False):
        """Cached build. ``refresh=True`` drops any existing entry first —
        the fault-injection harness uses it to force the cold path (an
        evicted plan) on a live server. Misses time the build under a
        ``plan_build`` span; hits/misses bump the tracer's counters."""
        trace = get_tracer()
        with self._lock:
            if refresh:
                self._fns.pop(key, None)
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                trace.count("plan_cache_hits")
                return fn
            self.misses += 1
            trace.count("plan_cache_misses")
        t0 = time.perf_counter()
        with trace.span("plan_build", kind=str(key[0])):
            fn = build()                        # build outside the lock
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.build_ms += dt_ms
            return self._fns.setdefault(key, fn)

    def _mark_trace(self):
        with self._lock:
            self.traces += 1
        get_tracer().count("plan_cache_traces")

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._fns), "hits": self.hits,
                    "misses": self.misses, "traces": self.traces,
                    "build_ms": round(self.build_ms, 3)}

    def clear(self):
        with self._lock:
            self._fns.clear()
            self.hits = self.misses = self.traces = 0
            self.build_ms = 0.0

    # -- entries ----------------------------------------------------------
    def frame_decoder(self, cfg: DecoderConfig, mesh=None, device=None):
        """The backend-dispatch ``decode_frames`` closure for ``cfg`` on
        ``device`` — ONE closure per (cfg, device). With ``mesh``, the
        frame axis is sharded across the mesh's devices — ONE closure per
        (cfg, mesh) (distributed/stream.py)."""
        mesh, dev = resolve_placement(mesh, device)
        if mesh is None:
            return self._get(("frames", cfg, dev),
                             lambda: _build_frame_decoder(cfg, dev))

        def build():
            from ..distributed.stream import make_sharded_frame_decoder
            return make_sharded_frame_decoder(cfg, mesh)

        return self._get(("frames", cfg, mesh), build)

    def window_decoder(self, cfg: DecoderConfig, nframes: int, *, mesh=None,
                       device=None):
        """Chunk-window decoder (stream layer). Callers with a custom
        decode_frames closure memoize their own ``build_window_fn``
        result — an anonymous closure has no stable identity to key on."""
        mesh, dev = resolve_placement(mesh, device)
        key = ("window", cfg, int(nframes), mesh, dev)
        return self._get(key, lambda: build_window_fn(
            cfg.spec, self.frame_decoder(cfg, mesh, device=dev),
            int(nframes), self._mark_trace))

    def batch_decoder(self, cfg: DecoderConfig, nframes: int, *, mesh=None,
                      refresh: bool = False, device=None):
        """(nframes, L, beta) frames -> (nframes, f) bits — the serve
        layer's one-launch-per-bucket entry point. ``nframes`` is the
        bucket's batch (slots x chunk_frames), so each bucket builds
        exactly once. ``refresh`` forces a rebuild (fault injection only —
        exercises the cold-cache path)."""
        mesh, dev = resolve_placement(mesh, device)
        key = ("batch", cfg, int(nframes), mesh, dev)

        def build():
            decode_frames = self.frame_decoder(cfg, mesh, device=dev)
            first = _once(self._mark_trace)

            def run(frames):
                first()
                return decode_frames(frames)

            return run

        return self._get(key, build, refresh=refresh)


#: Process-global cache: tenant churn anywhere in the process never
#: rebuilds a plan it has seen before.
PLAN_CACHE = PlanCache()
