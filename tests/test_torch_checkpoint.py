"""The port's durable sessions (StreamContext state, serve checkpoint and
restore, circuit breakers and failover) against the JAX package's, on
the CPU.

Mirrors tests/test_checkpoint.py, plus the cross-loads: a StreamContext
state dict (v1 and v2) is byte-for-byte the JAX context's and loads in
either package, and a server checkpoint written by either package
restores in the other and resumes bit-identically. The JAX side runs its
reference backend, the port ``device="cpu"``. Tolerance 0 throughout.
"""
import json

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_parity import counters, jax_decode, jcfg, rx
from repro.core import stream as jstream
from repro.core.framed import FrameSpec as JFrameSpec
from repro.serve import DecodeServer as JDecodeServer
from repro.serve import PlanCache as JPlanCache

from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig
from repro_torch.core.stream import STATE_VERSIONS, StreamContext
from repro_torch.core.trellis import STD_K7
from repro_torch.serve import (Breaker, CheckpointError, DecodeServer,
                               Draining, PlanCache, save_checkpoint)
from repro_torch.testing.faults import (FaultInjector, FaultSpec,
                                        InjectedCrash)

SPEC = FrameSpec(f=64, v1=16, v2=20)
SPEC34 = FrameSpec(f=63, v1=21, v2=21)


def _windows(ctx, pieces, flush):
    out = []
    for p in pieces:
        ctx.append(p)
        out += ctx.take_windows()
    if flush:
        out += ctx.flush_chunks()
    return [(w.frames(ctx.spec).tobytes(), w.n_bits) for w in out]


def _server(**kw):
    return DecodeServer(cache=PlanCache(), device="cpu", **kw)


# -- StreamContext state ---------------------------------------------------
@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from(["1/2", "3/4"]),
       st.sampled_from(list(STATE_VERSIONS)))
def test_context_state_roundtrip_and_cross_load(seed, rate, version):
    """Snapshot a context mid-stream at a random point of a random push
    schedule: the port's state dict is the JAX context's, byte for byte;
    each loads into a fresh context of the other package, and every later
    window (flush tail included) is bit-identical."""
    rng = np.random.default_rng(seed)
    spec = SPEC if rate == "1/2" else SPEC34
    n = int(rng.integers(2, 10)) * spec.f
    data = rx(n, rate, seed=seed % 1000)
    flat = data.reshape(-1)
    k = int(rng.integers(2, 7))
    cuts = np.sort(rng.choice(np.arange(1, flat.shape[0]), k, replace=False))
    pieces = np.split(flat, cuts)
    if rate == "1/2":
        pieces = np.split(data, np.unique(np.clip(cuts // 2, 1, n - 1)))
    cut = int(rng.integers(1, len(pieces)))
    C = int(rng.integers(1, 4))
    jspec = JFrameSpec(**vars(spec))
    ctx = StreamContext(spec, 2, C, rate)
    jctx = jstream.StreamContext(jspec, 2, C, rate)
    for p in pieces[:cut]:
        for c in (ctx, jctx):
            c.append(p)
            c.take_windows()
    state = json.loads(json.dumps(ctx.state_dict(version=version)))
    jstate = json.loads(json.dumps(jctx.state_dict(version=version)))
    assert json.dumps(state, sort_keys=True) == json.dumps(jstate,
                                                           sort_keys=True)
    fresh = StreamContext(spec, 2, C, rate)
    fresh.load_state(jstate)                     # JAX -> port
    jfresh = jstream.StreamContext(jspec, 2, C, rate)
    jfresh.load_state(state)                     # port -> JAX
    want = _windows(ctx, pieces[cut:], flush=True)
    assert _windows(fresh, pieces[cut:], flush=True) == want
    assert _windows(jfresh, pieces[cut:], flush=True) == want


def test_context_state_rejects_bad_version_geometry_and_crc():
    ctx = StreamContext(SPEC, STD_K7.beta, 2, "1/2")
    ctx.append(rx(3 * 64, seed=1))
    ctx.take_windows()
    state = ctx.state_dict()
    with pytest.raises(ValueError, match="version"):
        ctx.state_dict(version=99)
    with pytest.raises(ValueError, match="version"):
        StreamContext(SPEC, 2, 2, "1/2").load_state(dict(state, version=99))
    with pytest.raises(ValueError, match="geometry"):
        StreamContext(SPEC, 2, 3, "1/2").load_state(state)
    with pytest.raises(ValueError, match="geometry"):
        StreamContext(SPEC34, 2, 2, "3/4").load_state(state)
    target = StreamContext(SPEC, 2, 2, "1/2")
    with pytest.raises(ValueError, match="CRC"):
        target.load_state(dict(state, buf="AAAA" + state["buf"][4:]))
    assert target.n_in == 0                     # untouched by the failure
    with pytest.raises(ValueError, match="state dict"):
        target.load_state({"nonsense": True})


# -- server checkpoint / restore -------------------------------------------
def _queued_cut(srv, cfg12, cfg34, rxs, rx34):
    a = srv.open_session(cfg12, chunk_frames=2)
    b = srv.open_session(cfg12, chunk_frames=2)
    c = srv.open_session(cfg34, chunk_frames=3)
    srv.push(a, rxs[0][: 6 * 64])
    srv.push(b, rxs[1][: 4 * 64 + 13])          # ragged: carry mid-frame
    srv.push(c, rx34[:301])                     # mid-stage raw remainder
    srv.step()                                   # some launched (depth=1)
    srv.push(a, rxs[0][6 * 64:8 * 64])          # some still queued
    return a, b, c


def _finish(srv, finish):
    for sid, rest, _ in finish:
        srv.push(sid, rest)
    srv.drain()
    return {sid: np.concatenate([srv.poll(sid),
                                 srv.close_session(sid)])[:n]
            for sid, _, n in finish}


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_restore_bit_identical_with_queued_windows(
        writer, reader, tmp_path):
    """Kill a server with work at every pipeline position — undelivered
    bits, queued windows, half-pushed carry — and restore it in the same
    package or the other; both finish with the uninterrupted bits. A JAX
    checkpoint's bucket ids carry its planner's tile and are mapped onto
    the port's buckets, queued windows included; the JAX package maps
    nothing, so a port checkpoint with queued windows loads there when
    the tile is pinned (the two packages' bucket ids then agree)."""
    pin = {"frames_per_tile": 4} if reader == "jax" else {}
    cfg12 = DecoderConfig(spec=SPEC, backend="kernel", **pin)
    cfg34 = DecoderConfig(spec=SPEC34, rate="3/4", backend="kernel", **pin)
    n = 10 * 64
    rxs = {0: rx(n, seed=20), 1: rx(n, seed=21)}
    rx34 = rx(630, "3/4", seed=22)
    if writer == "port":
        srv = _server(slots=2)
        cfgs = (cfg12, cfg34)
    else:
        srv = JDecodeServer(slots=2, cache=JPlanCache())
        cfgs = (jcfg(cfg12), jcfg(cfg34))      # its kernel, interpreted
    a, b, c = _queued_cut(srv, *cfgs, rxs, rx34)
    ids = {bk.id for bk in srv.buckets()}
    path = str(tmp_path / "ckpt.json")
    srv.checkpoint(path)
    assert any(bk.queue for bk in srv.buckets())
    srv2 = (DecodeServer.restore(path, cache=PlanCache(), device="cpu")
            if reader == "port" else
            JDecodeServer.restore(path, cache=JPlanCache()))
    assert srv2.num_sessions == 3
    assert ({bk.id for bk in srv2.buckets()} == ids) == (writer == reader
                                                         or bool(pin))
    finish = [(a, rxs[0][8 * 64:], n), (b, rxs[1][4 * 64 + 13:], n),
              (c, rx34[301:], 630)]
    live, restored = _finish(srv, finish), _finish(srv2, finish)
    for sid, full, cfg, nb in ((a, rxs[0], cfg12, n), (b, rxs[1], cfg12, n),
                               (c, rx34, cfg34, 630)):
        want = jax_decode(cfg, full, nb)
        assert np.array_equal(live[sid], want)
        assert np.array_equal(restored[sid], want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_restore_of_a_drained_server(writer, tmp_path):
    """The operational handoff across packages at the planners' own
    tiles: drain(checkpoint) in one package, restore in the other (bucket
    ids differ by fingerprint and are mapped), the stream resumes
    bit-exactly and the metric counters carry over."""
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    rxa = rx(6 * 64, seed=40)
    path = str(tmp_path / "drain.json")
    if writer == "jax":
        srv = JDecodeServer(slots=2, cache=JPlanCache())
        sid = srv.open_session(jcfg(cfg, backend="reference"), chunk_frames=2)
    else:
        srv = _server(slots=2)
        sid = srv.open_session(cfg, chunk_frames=2)
    srv.push(sid, rxa[: 4 * 64])
    srv.drain(checkpoint=path)
    before = counters(srv.metrics_snapshot())
    if writer == "jax":
        srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    else:
        srv2 = JDecodeServer.restore(path, cache=JPlanCache())
    after = counters(srv2.metrics_snapshot())
    for key in ("launches", "windows", "frames", "bits"):
        assert after["totals"][key] == before["totals"][key], key
    assert after["checkpoint"] == {"saves": 1, "restores": 1}
    srv2.push(sid, rxa[4 * 64:])
    got = np.concatenate([srv2.poll(sid), srv2.close_session(sid)])
    assert np.array_equal(got, jax_decode(cfg, rxa, 6 * 64))
    if writer == "jax":                          # mapped onto one row
        assert len(srv2.metrics_snapshot()["buckets"]) == 1


def test_restore_preserves_metrics_counters_and_uptime(tmp_path):
    cfg = DecoderConfig(spec=SPEC)
    faults = FaultInjector(FaultSpec("launch_error", every=2), seed=0)
    srv = _server(slots=2, faults=faults, max_retries=1, backoff_s=0.0)
    sid = srv.open_session(cfg, chunk_frames=2)
    srv.push(sid, rx(8 * 64, seed=30))
    srv.drain()
    before = srv.metrics_snapshot()
    assert before["totals"]["launch_errors"] > 0
    path = str(tmp_path / "m.json")
    srv.checkpoint(path)
    srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    after = srv2.metrics_snapshot()
    for c in ("launch_errors", "retries", "degraded", "launches", "bits"):
        assert after["totals"][c] == before["totals"][c], c
    assert after["totals"]["uptime_s"] >= before["totals"]["uptime_s"]
    assert after["checkpoint"] == {"saves": 1, "restores": 1}
    assert (after["stages"]["launch_ms"]["count"]
            == before["stages"]["launch_ms"]["count"])


def test_checkpoint_after_tenant_churn_restores(tmp_path):
    cfg12 = DecoderConfig(spec=SPEC)
    cfg34 = DecoderConfig(spec=SPEC34, rate="3/4")
    srv = _server(slots=2)
    churned = srv.open_session(cfg12, chunk_frames=2)
    srv.push(churned, rx(4 * 64, seed=80))
    srv.drain()
    srv.close_session(churned)
    live = srv.open_session(cfg34, chunk_frames=3)
    rx34 = rx(630, "3/4", seed=81)
    srv.push(live, rx34[:301])
    path = str(tmp_path / "churn.json")
    srv.checkpoint(path)
    srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    assert srv2.num_sessions == 1
    assert list(srv2.metrics_snapshot()["breakers"].values()) \
        == [{"state": "closed", "trips": 0, "consecutive": 0}]
    srv2.push(live, rx34[301:])
    got = np.concatenate([srv2.poll(live), srv2.close_session(live)])[:630]
    assert np.array_equal(got, jax_decode(cfg34, rx34, 630))
    fresh = rx(4 * 64, seed=82)
    sid = srv2.open_session(cfg12, chunk_frames=2)
    srv2.push(sid, fresh)
    got = np.concatenate([srv2.poll(sid), srv2.close_session(sid)])
    assert np.array_equal(got, jax_decode(cfg12, fresh, 4 * 64))


def test_checkpoint_all_sessions_closed_restores_empty(tmp_path):
    srv = _server(slots=2)
    sid = srv.open_session(DecoderConfig(spec=SPEC), chunk_frames=2)
    srv.push(sid, rx(4 * 64, seed=83))
    srv.drain()
    srv.close_session(sid)
    path = str(tmp_path / "empty.json")
    srv.checkpoint(path)
    srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    assert srv2.num_sessions == 0
    assert srv2.metrics_snapshot()["breakers"] == {}


def test_corrupt_and_mismatched_checkpoints_are_rejected(tmp_path):
    srv = _server()
    srv.open_session(DecoderConfig(spec=SPEC), chunk_frames=2)
    path = str(tmp_path / "bad.json")
    srv.checkpoint(path)
    raw = open(path, "rb").read()
    kw = dict(device="cpu")
    with pytest.raises(CheckpointError, match="cannot read"):
        DecodeServer.restore(path + ".nope", **kw)
    doc = json.loads(raw.decode())
    doc["payload"]["next_sid"] += 1
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(CheckpointError, match="CRC"):
        DecodeServer.restore(path, **kw)
    open(path, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="JSON"):
        DecodeServer.restore(path, **kw)
    doc = json.loads(raw.decode())
    doc["schema"] = "repro.serve.checkpoint/v999"
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(CheckpointError, match="schema"):
        DecodeServer.restore(path, **kw)
    open(path, "w").write("[1, 2, 3]")
    with pytest.raises(CheckpointError, match="envelope"):
        DecodeServer.restore(path, **kw)


def test_checkpoint_corrupt_fault_is_caught_at_restore(tmp_path):
    path, good = str(tmp_path / "f.json"), str(tmp_path / "good.json")
    faults = FaultInjector(FaultSpec("checkpoint_corrupt", after=2), seed=0)
    srv = _server(faults=faults)
    srv.open_session(DecoderConfig(spec=SPEC), chunk_frames=2)
    save_checkpoint(srv, good)                   # write #1: clean
    save_checkpoint(srv, path)                   # write #2: corrupted
    with pytest.raises(CheckpointError):
        DecodeServer.restore(path, device="cpu")
    assert DecodeServer.restore(good, device="cpu").num_sessions == 1


def test_drain_refuses_admission_and_pushes_then_snapshots(tmp_path):
    cfg = DecoderConfig(spec=SPEC)
    srv = _server(slots=2)
    sid = srv.open_session(cfg, chunk_frames=2)
    data = rx(6 * 64, seed=40)
    srv.push(sid, data[: 4 * 64])
    path = str(tmp_path / "d.json")
    srv.drain(checkpoint=path)
    assert srv.metrics_snapshot()["draining"]
    with pytest.raises(Draining):
        srv.open_session(cfg, chunk_frames=2)
    with pytest.raises(Draining):
        srv.push(sid, data[4 * 64:])
    assert srv.poll(sid).size > 0
    srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    assert not srv2.metrics_snapshot()["draining"]
    srv2.push(sid, data[4 * 64:])
    got = np.concatenate([srv2.poll(sid), srv2.close_session(sid)])
    assert np.array_equal(got, jax_decode(cfg, data, 6 * 64))


# -- circuit breaker + failover ---------------------------------------------
def test_breaker_state_machine_equals_jax():
    from repro.serve import Breaker as JBreaker
    states = []
    for cls in (Breaker, JBreaker):
        br = cls(threshold=2, cooldown=2)
        seq = [br.record_failure(), br.state, br.record_failure(), br.state]
        br.step()
        seq.append(br.state)
        br.step()
        seq += [br.state, br.record_failure(), br.trips]
        br.step(), br.step()
        seq += [br.state, br.record_success(), br.state, br.state_dict()]
        states.append(seq)
    assert states[0] == states[1]
    rt = Breaker(threshold=2, cooldown=2)
    rt.load_state(states[0][-1])
    assert rt.state_dict() == states[0][-1]
    with pytest.raises(ValueError):
        rt.load_state({"state": "on fire", "consecutive": 0, "trips": 0,
                       "wait": 0})


def _device_loss_run(srv_cls, cfg, kw):
    faults = (kw.pop("faults_cls"))(
        kw.pop("spec_cls")("device_loss", after=2, count=4), seed=0)
    srv = srv_cls(slots=2, max_retries=2, breaker_threshold=3,
                  breaker_cooldown=2, faults=faults, **kw)
    sid = srv.open_session(cfg, chunk_frames=2)
    primary = srv._sessions[sid].bucket
    n = 20 * 64
    data = rx(n, seed=50)
    outs, evacuated_seen, recovered = [], False, False
    for pos in range(0, n, 2 * 64):
        srv.push(sid, data[pos: pos + 2 * 64])
        srv.step()
        outs.append(srv.poll(sid))
        b = srv._sessions[sid].bucket
        evacuated_seen |= b.pinned
        recovered |= (evacuated_seen and not b.pinned)
    outs.append(srv.close_session(sid))
    return (np.concatenate(outs)[:n], data, evacuated_seen, recovered,
            primary, srv)


def test_device_loss_trips_breaker_evacuates_and_recovers_like_jax():
    """A persistent device loss trips the breaker, the session evacuates
    to the reference-pinned failover bucket and comes back after the
    half-open probe; bits exact throughout, and every counter (trips,
    evacuations, retries, degrades) equals the JAX server's."""
    from repro.testing import FaultInjector as JFaultInjector
    from repro.testing import FaultSpec as JFaultSpec
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    got, data, evac, rec, primary, srv = _device_loss_run(
        DecodeServer, cfg, dict(cache=PlanCache(), device="cpu",
                                faults_cls=FaultInjector,
                                spec_cls=FaultSpec))
    jgot, _, jevac, jrec, _, jsrv = _device_loss_run(
        JDecodeServer, jcfg(cfg, backend="reference"),
        dict(cache=JPlanCache(), faults_cls=JFaultInjector,
             spec_cls=JFaultSpec))
    assert np.array_equal(got, jax_decode(cfg, data, data.shape[0]))
    assert np.array_equal(got, jgot)
    assert evac and rec and (evac, rec) == (jevac, jrec)
    assert primary.breaker.state == "closed"
    snap = srv.metrics_snapshot()
    t = snap["totals"]
    assert t["breaker_trips"] >= 1 and t["evacuated"] == 1
    assert t["health"] == "degraded"
    assert snap["breakers"][primary.id]["trips"] == t["breaker_trips"]
    mine, theirs = counters(snap), counters(jsrv.metrics_snapshot())
    # the JAX side runs its reference backend, whose fallback program is
    # its primary one: the plan caches differ by that sharing only
    for c in (mine, theirs):
        c["totals"] = {k: v for k, v in c["totals"].items()
                       if k not in ("pad_frames", "occupancy")}
        del c["plan_cache"]
    assert mine == theirs


def test_open_breaker_routes_new_sessions_to_failover():
    cfg = DecoderConfig(spec=SPEC)
    faults = FaultInjector(FaultSpec("device_loss", after=1), seed=0)
    srv = _server(slots=2, max_retries=1, breaker_threshold=2,
                  breaker_cooldown=1000, faults=faults)
    s1 = srv.open_session(cfg, chunk_frames=2)
    srv.push(s1, rx(4 * 64, seed=60))
    srv.step()
    assert srv._sessions[s1].bucket.pinned
    s2 = srv.open_session(cfg, chunk_frames=2)
    assert srv._sessions[s2].bucket.pinned
    srv.close_session(s1), srv.close_session(s2)


def test_breaker_open_snapshot_keeps_trip_streak_on_late_success():
    cfg = DecoderConfig(spec=SPEC)
    faults = FaultInjector(FaultSpec("device_loss", after=1, count=2),
                           seed=0)
    srv = _server(slots=2, max_retries=2, breaker_threshold=2,
                  breaker_cooldown=1000, backoff_s=0.0, faults=faults)
    sid = srv.open_session(cfg, chunk_frames=2)
    primary = srv._sessions[sid].bucket
    srv.push(sid, rx(4 * 64, seed=84))
    srv.step()
    assert srv._sessions[sid].bucket.pinned
    row = srv.metrics_snapshot()["breakers"][primary.id]
    assert row["state"] == "open"
    assert row["consecutive"] >= srv.breaker_threshold
    srv.close_session(sid)


def test_checkpoint_mid_outage_restores_evacuated_placement(tmp_path):
    cfg = DecoderConfig(spec=SPEC)
    faults = FaultInjector(FaultSpec("device_loss", after=1), seed=0)
    srv = _server(slots=2, max_retries=1, breaker_threshold=2,
                  breaker_cooldown=1000, faults=faults)
    sid = srv.open_session(cfg, chunk_frames=2)
    n = 8 * 64
    data = rx(n, seed=61)
    srv.push(sid, data[: 4 * 64])
    srv.step()
    assert srv._sessions[sid].bucket.pinned
    path = str(tmp_path / "outage.json")
    srv.checkpoint(path)
    srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cpu")
    assert srv2._sessions[sid].bucket.pinned
    assert any(v["state"] == "open"
               for v in srv2.metrics_snapshot()["breakers"].values())
    srv2.push(sid, data[4 * 64:])
    got = np.concatenate([srv2.poll(sid), srv2.close_session(sid)])[:n]
    assert np.array_equal(got, jax_decode(cfg, data, n))


def test_kill_restore_compare_deterministic(tmp_path):
    """Seeded crash_at_step kills the server mid-workload; the client
    restores from its last checkpoint, rewinds and replays: every
    session's bits equal the solo decode, twice over."""
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    n = 16 * 64
    rxs = {0: rx(n, seed=70), 1: rx(n, seed=71)}
    path = str(tmp_path / "crash.json")

    def run():
        faults = FaultInjector(FaultSpec("crash_at_step", after=3, count=1),
                               seed=0)
        srv = _server(slots=4, faults=faults)
        sids = {k: srv.open_session(cfg, chunk_frames=2) for k in rxs}
        pos = {k: 0 for k in rxs}
        bits = {k: [] for k in rxs}
        mark = ({k: 0 for k in rxs}, {k: 0 for k in rxs})
        srv.checkpoint(path)
        crashes = 0
        while any(p < n for p in pos.values()):
            try:
                for k, sid in sids.items():
                    if pos[k] < n:
                        srv.push(sid, rxs[k][pos[k]: pos[k] + 2 * 64])
                        pos[k] += 2 * 64
                srv.step()
                for k, sid in sids.items():
                    bits[k].append(srv.poll(sid))
                srv.checkpoint(path)
                mark = ({k: sum(len(x) for x in bits[k]) for k in rxs},
                        dict(pos))
            except InjectedCrash:
                crashes += 1
                srv = DecodeServer.restore(path, cache=PlanCache(),
                                           device="cpu")
                delivered, posmark = mark
                for k in rxs:
                    acc = (np.concatenate(bits[k]) if bits[k]
                           else np.zeros(0, np.int32))
                    bits[k] = [acc[: delivered[k]]]
                pos = dict(posmark)
        assert crashes == 1
        for k, sid in sids.items():
            bits[k].append(srv.close_session(sid))
        return ({k: np.concatenate(bits[k])[:n] for k in rxs},
                srv.metrics_snapshot()["checkpoint"]["restores"])

    got1, restores1 = run()
    got2, restores2 = run()
    assert restores1 == restores2 == 1
    for k in rxs:
        assert np.array_equal(got1[k], jax_decode(cfg, rxs[k], n))
        assert np.array_equal(got2[k], got1[k])
