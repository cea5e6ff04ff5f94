"""Durable checkpoints for the decode service (serve/server.py); port of
``repro.serve.checkpoint``, with the same schema, CRC and atomic write.

A checkpoint is one JSON document capturing EVERYTHING a fresh process
needs to resume every live stream bit-identically:

  * the server's constructor knobs (``DecodeServer.init_kwargs``) — the
    restored server is configured like the one that saved;
  * every session: its code config (trellis/spec/rate/backend knobs),
    the bounded carry state of its stream context
    (``StreamContext.state_dict`` — overlap buffer, depuncture phase,
    raw remainder, counters), quarantine strikes, and any decoded bits
    the client had not yet polled (bit-packed);
  * every bucket's still-queued windows (the frames a crash would
    otherwise strand between push and launch);
  * every circuit breaker's state and the full metrics state (fault
    counters, latency histograms, accumulated uptime) — the restored
    ``metrics_snapshot()`` tells one continuous story across the crash.

The write is ATOMIC (tmp file + ``os.replace`` — a crash mid-save leaves
the previous checkpoint intact, never a torn file) and SELF-VALIDATING: a
CRC-32 over the canonical payload JSON plus a schema string. The load
path refuses — with a structured ``CheckpointError``, never a half-loaded
server — anything missing, unparseable, schema-mismatched, or failing
its CRC (``testing.faults`` ``checkpoint_corrupt`` drives that
rejection in the tests).

Consistency model: ``save_checkpoint`` first retires every in-flight
launch (materializing those bits into the sessions' ready queues), so
the snapshot is a consistent cut — each window is either still queued
(saved raw) or fully decoded (saved as bits); nothing is in between.

What is deliberately NOT saved: decode programs (the plan cache rebuilds
them from the configs — one per bucket, same as a cold start),
meshes/devices, fault injectors, tracers. Those are process-local and
passed fresh to ``DecodeServer.restore``.

Between the packages. The document is the JAX package's, field for
field, so a checkpoint written by either restores in the other. A bucket
id is ``K{k}-f{f}-C{chunk}-{plan fingerprint}``, and the fingerprint
hashes the tile each package's planner chose for its own chip; restore
therefore maps a saved id that the restored server does not have to the
restored bucket of the same code, frame length and chunk (and failover
flag) — the queued windows, breaker and metrics of the saving server
land on the bucket that now decodes those sessions. Sessions must have
been opened with an explicit ``chunk_frames`` for that (the default
chunk follows each package's tile, and a stream context refuses a state
of another geometry).
"""
from __future__ import annotations

import base64
import collections
import dataclasses
import json
import os
import time
import zlib

import numpy as np

from ..core.framed import FrameSpec
from ..core.pipeline import DecoderConfig
from ..core.trellis import make_trellis
from .scheduler import PendingWindow
from .server import ServeError

__all__ = ["CheckpointError", "SCHEMA", "save_checkpoint",
           "load_checkpoint", "restore_server", "encode_cfg", "decode_cfg"]

#: Schema tag written into (and demanded of) every checkpoint file — the
#: JAX package's, since the payloads are the same. Bump it (in both
#: packages) when the payload shape changes incompatibly.
SCHEMA = "repro.serve.checkpoint/v1"


class CheckpointError(ServeError):
    """A checkpoint could not be written or loaded (missing, truncated,
    corrupt, or schema-mismatched file). ``retry_after_steps`` is None:
    retrying won't help — point at a valid checkpoint instead."""

    def __init__(self, msg: str):
        super().__init__(msg, retry_after_steps=None)


# -- config (de)serialization ---------------------------------------------
#: DecoderConfig's plain (JSON-native) fields; trellis and spec are
#: handled structurally.
_CFG_FIELDS = ("rate", "backend", "interpret", "pack_survivors", "radix",
               "frames_per_tile", "layout", "bm_dtype", "renorm_every",
               "block_frames", "overlap")


def encode_cfg(cfg: DecoderConfig) -> dict:
    """JSON-ready form of a DecoderConfig. The trellis serializes as its
    (k, polys) recipe — ``make_trellis`` is lru_cached, so decoding
    returns the canonical instance (identity-hashed)."""
    return {"trellis": {"k": cfg.trellis.k,
                        "polys": [int(p) for p in cfg.trellis.polys]},
            "spec": dataclasses.asdict(cfg.spec),
            **{f: getattr(cfg, f) for f in _CFG_FIELDS}}


def decode_cfg(data: dict) -> DecoderConfig:
    trellis = make_trellis(int(data["trellis"]["k"]),
                           tuple(int(p) for p in data["trellis"]["polys"]))
    spec = FrameSpec(**data["spec"])
    # fields absent from older checkpoints take the dataclass default
    # (e.g. block_frames/overlap on pre-block-mode files)
    return DecoderConfig(trellis=trellis, spec=spec,
                         **{f: data[f] for f in _CFG_FIELDS if f in data})


# -- binary payload helpers ------------------------------------------------
def _enc_bits(bits: np.ndarray) -> dict:
    """Decoded bits (0/1 int32) -> bit-packed base64 (~32x smaller than
    JSON int lists)."""
    arr = np.asarray(bits, np.uint8)
    return {"n": int(arr.size),
            "b64": base64.b64encode(np.packbits(arr).tobytes())
                   .decode("ascii")}


def _dec_bits(data: dict) -> np.ndarray:
    raw = np.frombuffer(
        base64.b64decode(data["b64"].encode("ascii"), validate=True),
        np.uint8)
    n = int(data["n"])
    if raw.size * 8 < n:
        raise ValueError(f"bit payload too short: {raw.size * 8} < {n}")
    return np.unpackbits(raw)[:n].astype(np.int32)


def _enc_f32(arr: np.ndarray) -> dict:
    """float32 array -> base64 of little-endian bytes, shape alongside."""
    a = np.ascontiguousarray(arr, dtype="<f4")
    return {"shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_f32(data: dict) -> np.ndarray:
    raw = base64.b64decode(data["b64"].encode("ascii"), validate=True)
    return (np.frombuffer(raw, dtype="<f4").astype(np.float32)
            .reshape([int(s) for s in data["shape"]]))


def _canonical(payload: dict) -> bytes:
    """The byte string the CRC covers: sorted keys, no whitespace. JSON
    round-trips Python floats exactly (repr-based), so re-encoding the
    parsed payload at load time reproduces these bytes bit-for-bit."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _fsync_dir(dirpath: str) -> None:
    """Make a completed ``os.replace`` itself durable: fsync the
    containing directory so the new directory entry survives power loss,
    not just the file bytes. Best-effort — platforms whose directories
    cannot be opened or fsynced (e.g. Windows) skip it; the previous
    checkpoint is still intact either way."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- save ------------------------------------------------------------------
def save_checkpoint(server, path: str) -> str:
    """Snapshot ``server`` to ``path`` atomically; returns ``path``.

    Retires all in-flight launches first (the consistent cut — see
    module docstring). The server keeps running afterwards; pair with
    ``server.drain(checkpoint=path)`` for the stop-the-world handoff.
    """
    with server.trace.span("checkpoint_save", path=str(path),
                           sessions=len(server._sessions)) as sp:
        for bucket in server.buckets():
            server._retire(bucket, 0)
        sessions = []
        for sid, s in sorted(server._sessions.items()):
            sessions.append({
                "sid": sid,
                "cfg": encode_cfg(s.cfg),
                "chunk_frames": s.chunk_frames_arg,
                "strikes": s.strikes,
                "quarantined": s.quarantined,
                "ready": [_enc_bits(r) for r in s.ready],
                "ctx": s.ctx.state_dict(),
            })
        queues = {}
        for bucket in server.buckets():
            if bucket.queue:
                queues[bucket.id] = [
                    {"sid": w.session.sid, "frames": _enc_f32(w.frames),
                     "n_bits": int(w.n_bits)} for w in bucket.queue]
        payload = {
            "server": server.init_kwargs(),
            "next_sid": server._next_sid,
            "saves": server.checkpoint_saves + 1,
            "restores": server.checkpoint_restores,
            "sessions": sessions,
            "queues": queues,
            "breakers": {b.id: b.breaker.state_dict()
                         for b in server.buckets() if not b.pinned},
            "metrics": server.metrics.state_dict(),
        }
        doc = {"schema": SCHEMA, "crc": zlib.crc32(_canonical(payload)),
               "payload": payload}
        data = json.dumps(doc, sort_keys=True).encode("utf-8")
        if server.faults is not None:
            data = server.faults.checkpoint_bytes(data)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        server.checkpoint_saves += 1
        sp.set(bytes=len(data))
    return path


# -- load ------------------------------------------------------------------
def load_checkpoint(path: str) -> dict:
    """Read + validate a checkpoint file; returns the payload dict.
    Raises ``CheckpointError`` (missing / not JSON / wrong schema / CRC
    mismatch) — the caller never sees a payload that didn't verify."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as e:
        raise CheckpointError(
            f"cannot read checkpoint {path!r}: {e}") from None
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} is not valid JSON ({e}); the file is "
            f"truncated or corrupt") from None
    if not isinstance(doc, dict) or "payload" not in doc:
        raise CheckpointError(
            f"checkpoint {path!r} has no payload envelope; not a serve "
            f"checkpoint")
    if doc.get("schema") != SCHEMA:
        raise CheckpointError(
            f"checkpoint {path!r} has schema {doc.get('schema')!r}; this "
            f"server reads {SCHEMA!r} — refusing a cross-version load")
    if zlib.crc32(_canonical(doc["payload"])) != doc.get("crc"):
        raise CheckpointError(
            f"checkpoint {path!r} failed its CRC check — the payload was "
            f"corrupted after write; refusing to half-load it")
    return doc["payload"]


def restore_server(cls, path: str, *, mesh=None, cache=None, faults=None,
                   trace=None, device=None):
    """Rebuild a ``cls`` (DecodeServer) instance from ``path``. Invoked
    via ``DecodeServer.restore``; see there for the contract."""
    payload = load_checkpoint(path)
    try:
        srv = cls(mesh=mesh, cache=cache, faults=faults, trace=trace,
                  device=device, **payload["server"])
    except (TypeError, AssertionError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} carries unusable server config: "
            f"{e!r}") from None
    with srv.trace.span("checkpoint_restore", path=str(path),
                        sessions=len(payload.get("sessions", ()))):
        try:
            _load_into(srv, payload)
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise CheckpointError(
                f"checkpoint {path!r} is structurally invalid: "
                f"{e!r}") from None
    srv.checkpoint_restores = int(payload["restores"]) + 1
    return srv


def _structure(bucket_id: str) -> tuple:
    """A bucket id without its plan fingerprint: K, f, chunk, failover."""
    parts = bucket_id.split("-")
    return (*parts[:3], parts[-1] == "failover")


def _foreign_ids(srv, payload: dict) -> dict:
    """Saved bucket id -> restored bucket id, for saved ids the restored
    server does not have (written by the other package): where exactly one
    such id and exactly one restored bucket of no saved id share a
    structure, the one is the other."""
    restored = {b.id for b in srv.buckets()}
    saved = (set(payload["breakers"]) | set(payload["queues"])
             | set(payload["metrics"]["buckets"]))
    foreign, spare = collections.defaultdict(list), collections.defaultdict(list)
    for bid in saved - restored:
        foreign[_structure(bid)].append(bid)
    for bid in restored - saved:
        spare[_structure(bid)].append(bid)
    return {ids[0]: spare[st][0] for st, ids in foreign.items()
            if len(ids) == 1 and len(spare[st]) == 1}


def _queue_bucket(srv, bucket_id: str, rows):
    """The restored bucket of a saved queue: the one of that id, else —
    an id of the other package — the bucket of the same structure that
    holds every queued window's session."""
    for b in srv.buckets():
        if b.id == bucket_id:
            return b
    owners = {srv._sessions[int(row["sid"])].bucket for row in rows}
    if len(owners) == 1:
        (b,) = owners
        if _structure(b.id) == _structure(bucket_id):
            return b
    return None


def _load_into(srv, payload: dict) -> None:
    """Populate a freshly constructed server from a verified payload."""
    for row in payload["sessions"]:
        cfg = decode_cfg(row["cfg"])
        sid = srv._admit(cfg, row["chunk_frames"], sid=int(row["sid"]))
        s = srv._sessions[sid]
        s.ctx.load_state(row["ctx"])
        s.strikes = int(row["strikes"])
        s.quarantined = row["quarantined"]
        s.ready = [_dec_bits(d) for d in row["ready"]]
    srv._next_sid = int(payload["next_sid"])
    # breaker states land after admission (buckets now exist); sessions
    # of a bucket whose breaker did not come back closed move straight
    # to its failover bucket — silently: the evacuation already happened
    # in the previous process and its counters are restored below.
    by_id = {b.id: b for b in srv.buckets()}
    foreign = _foreign_ids(srv, payload)
    for bid, state in payload["breakers"].items():
        bucket = by_id.get(foreign.get(bid, bid))
        if bucket is None:
            # Buckets outlive their last session in the saving server
            # (normal tenant churn: open -> drain -> close leaves the
            # bucket, and its breaker, behind in _buckets), but restore
            # only rebuilds buckets some live session maps to. A breaker
            # with no bucket to land on guards nothing the restored
            # server can reach — drop it. A later open_session of that
            # cfg starts with a fresh closed breaker and re-probes the
            # device, which a process restart warrants anyway.
            continue
        bucket.breaker.load_state(state)
    for bucket in list(srv.buckets()):
        if not bucket.pinned and bucket.breaker.state != "closed" \
                and bucket.sessions:
            target = srv._failover_bucket(bucket)
            for sid in list(bucket.sessions):
                session = srv._sessions[sid]
                session.bucket = target
                target.sessions.add(sid)
            bucket.sessions.clear()
    for bid, rows in payload["queues"].items():
        bucket = _queue_bucket(srv, bid, rows)
        if bucket is None:
            raise ValueError(f"queued windows name unknown bucket {bid!r}")
        for row in rows:
            session = srv._sessions[int(row["sid"])]
            bucket.queue.append(
                PendingWindow(session, _dec_f32(row["frames"]),
                              int(row["n_bits"]), time.perf_counter()))
            session.inflight += 1
    foreign = _foreign_ids(srv, payload)     # failover buckets now exist
    metrics = dict(payload["metrics"])
    metrics["buckets"] = {foreign.get(bid, bid): mstate
                          for bid, mstate in metrics["buckets"].items()}
    srv.metrics.load_state(metrics)
    srv.checkpoint_saves = int(payload["saves"])
