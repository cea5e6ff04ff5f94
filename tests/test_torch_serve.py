"""The port's decode service (repro_torch.serve) against the JAX package's,
on the CPU.

Mirrors tests/test_serve.py: per-session bits equal to stream_decode,
bucket grouping, the plan cache (one program per (trellis, spec, plan,
nframes) bucket), admission and backpressure, and the per-bucket metrics.
The same seeded numpy streams and the same push/step schedule go through
both packages' servers (the JAX one on its reference backend, the port
with ``device="cpu"``): the bits, the plan cache's ``stats()`` (bar its
build clock) and the metrics snapshot's counters (bar its clocks) are
equal. Tolerance 0 throughout.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import counters, jax_decode, jcfg, rx
from repro.core.stream import make_stream_decoder as jmake_stream_decoder
from repro.serve import DecodeServer as JDecodeServer
from repro.serve import PlanCache as JPlanCache

from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig
from repro_torch.core.stream import make_stream_decoder, stream_decode
from repro_torch.core.trellis import STD_K7, make_trellis
from repro_torch.serve import (Backpressure, DecodeServer, PlanCache,
                               ServerFull, bucket_plan)

SRC = Path(__file__).resolve().parents[1] / "src"
SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
SPEC34 = FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)
K5 = make_trellis(5, (0o23, 0o35))


def _run_eight(srv_cls, cache, cfgs, backend_of):
    """The JAX test's eight-session workload, schedule and all; returns
    (bits by session, server)."""
    srv = srv_cls(slots=3, queue_depth=4, cache=cache, **backend_of)
    data = []
    for i in range(8):
        cfg = cfgs[i % 3]
        n = 1800 + 137 * i
        data.append((srv.open_session(cfg, chunk_frames=5), cfg,
                     rx(n, cfg.rate, seed=i, trellis=_tr(cfg)), n))
    pos = [0] * len(data)
    sizes = (311, 1000, 97, 1200)
    outs = {sid: [] for sid, _, _, _ in data}
    rnd, done = 0, False
    while not done:
        done = True
        for j, (sid, cfg, llr, n) in enumerate(data):
            if pos[j] >= llr.shape[0]:
                continue
            done = False
            sz = sizes[(j + rnd) % len(sizes)]
            try:
                srv.push(sid, llr[pos[j]:pos[j] + sz])
                pos[j] += sz
            except Exception as e:                   # either Backpressure
                assert type(e).__name__ == "Backpressure"
                srv.step()
        srv.step()
        for sid, _, _, _ in data:
            outs[sid].append(srv.poll(sid))
        rnd += 1
    bits = {}
    for sid, cfg, llr, n in data:
        outs[sid].append(srv.close_session(sid))
        bits[sid] = (np.concatenate(outs[sid])[:n], cfg, llr, n)
    return bits, srv


def _tr(cfg):
    return make_trellis(cfg.trellis.k, cfg.trellis.polys)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_server_eight_sessions_bit_exact_and_counters_equal_jax(backend):
    """Eight sessions across K=7, K=7 rate 3/4 and K=5, ragged interleaved
    pushes: every session's bits equal stream_decode and the JAX server's;
    the JAX workload's plan-cache stats and metric counters are the
    port's."""
    cfgs = [DecoderConfig(spec=SPEC, backend=backend),
            DecoderConfig(spec=SPEC34, rate="3/4", backend=backend),
            DecoderConfig(trellis=K5, spec=SPEC, backend=backend)]
    cache = PlanCache()
    bits, srv = _run_eight(DecodeServer, cache, cfgs, {"device": "cpu"})
    jbits, jsrv = _run_eight(JDecodeServer, JPlanCache(),
                             [jcfg(c, backend="reference") for c in cfgs], {})
    assert len({b.id for b in srv.buckets()}) == 3
    for sid, (got, cfg, llr, n) in bits.items():
        assert np.array_equal(got, jbits[sid][0]), f"session {sid}"
        assert np.array_equal(got, stream_decode(cfg, llr, n, chunk_frames=5,
                                                 device="cpu"))
    stats = cache.stats()
    assert stats["traces"] == stats["misses"] - 3      # 3 frame closures
    assert stats["hits"] > stats["misses"]
    assert srv.num_sessions == 0
    got, want = counters(srv.metrics_snapshot()), counters(
        jsrv.metrics_snapshot())
    if backend == "kernel":                            # the port pads tiles
        for c in (got, want):
            c["totals"] = {k: v for k, v in c["totals"].items()
                           if k not in ("pad_frames", "occupancy")}
    assert got == want


def test_one_program_per_bucket_under_churn():
    """Generations of sessions open, decode and close: the program count
    stops at one per batch shape — as in the JAX package."""
    cfg = DecoderConfig(spec=SPEC)
    stats = []
    for srv_cls, cache, c, kw in (
            (DecodeServer, PlanCache(), cfg, {"device": "cpu"}),
            (JDecodeServer, JPlanCache(), jcfg(cfg), {})):
        srv = srv_cls(slots=2, cache=cache, **kw)
        C, n = 4, 4 * 64
        llr = rx(n + SPEC.v2, seed=0)                 # one FULL window
        for gen in range(3):
            sids = [srv.open_session(c, chunk_frames=C) for _ in range(2)]
            for sid in sids:
                srv.push(sid, llr)
            assert srv.step() == 2                     # one 2-window launch
            for sid in sids:
                got = np.concatenate([srv.poll(sid), srv.close_session(sid)])
                assert np.array_equal(got[:n + SPEC.v2],
                                      jax_decode(cfg, llr, n + SPEC.v2))
        stats.append({k: v for k, v in cache.stats().items()
                      if k != "build_ms"})
    assert stats[0] == stats[1]
    assert stats[0]["traces"] == 2 and stats[0]["misses"] == 3


def test_plan_cache_shared_across_stream_decoders():
    cfg = DecoderConfig(spec=SPEC)
    llr = rx(9 * 64, seed=3)          # one 5-frame chunk + 4-frame tail
    stats = []
    for make, cache, c, kw in (
            (make_stream_decoder, PlanCache(), cfg, {"device": "cpu"}),
            (jmake_stream_decoder, JPlanCache(), jcfg(cfg), {})):
        outs = []
        for _ in range(3):
            dec = make(c, chunk_frames=5, cache=cache, **kw)
            outs.append(np.concatenate([dec.push(llr), dec.flush()]))
        assert all(np.array_equal(o, jax_decode(cfg, llr, 9 * 64))
                   for o in outs)
        stats.append({k: v for k, v in cache.stats().items()
                      if k != "build_ms"})
    assert stats[0] == stats[1]
    assert stats[0]["traces"] == 2                     # chunk fn + tail fn


def test_punctured_sessions_share_bucket_with_rate_half():
    c12 = DecoderConfig(spec=SPEC34, backend="kernel")
    c34 = DecoderConfig(spec=SPEC34, rate="3/4", backend="kernel")
    srv = DecodeServer(slots=2, cache=PlanCache(), device="cpu")
    n = 1890
    s12 = srv.open_session(c12, chunk_frames=4)
    s34 = srv.open_session(c34, chunk_frames=4)
    assert len(srv.buckets()) == 1
    llr12, raw34 = rx(n, seed=11), rx(n, "3/4", seed=12)
    srv.push(s12, llr12)
    srv.push(s34, raw34)
    srv.drain()
    got12 = np.concatenate([srv.poll(s12), srv.close_session(s12)])[:n]
    got34 = np.concatenate([srv.poll(s34), srv.close_session(s34)])[:n]
    assert np.array_equal(got12, jax_decode(c12, llr12, n))
    assert np.array_equal(got34, jax_decode(c34, raw34, n))


def test_admission_control():
    srv = DecodeServer(max_sessions=2, cache=PlanCache(), device="cpu")
    cfg = DecoderConfig(spec=SPEC)
    a = srv.open_session(cfg)
    srv.open_session(cfg)
    with pytest.raises(ServerFull, match="max_sessions"):
        srv.open_session(cfg)
    srv.close_session(a)                               # freeing re-admits
    srv.open_session(cfg)


def test_close_session_tail_longer_than_one_chunk():
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    srv = DecodeServer(cache=PlanCache(), device="cpu")
    n = 330                            # chunk covers 320; tail = 330 > 320
    llr = rx(n, seed=31)
    sid = srv.open_session(cfg, chunk_frames=5)
    srv.push(sid, llr)
    assert srv._session(sid).inflight == 0             # no complete window
    got = srv.close_session(sid)
    assert got.shape == (n,)
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_push_larger_than_queue_depth_raises_before_absorbing():
    cfg = DecoderConfig(spec=SPEC)
    srv = DecodeServer(queue_depth=2, slots=8, cache=PlanCache(),
                       device="cpu")
    sid = srv.open_session(cfg, chunk_frames=2)
    n = 10 * 128
    llr = rx(n, seed=17)
    with pytest.raises(Backpressure, match="split"):
        srv.push(sid, llr)
    assert srv._session(sid).inflight == 0
    for i in range(0, n, 128):
        srv.push(sid, llr[i:i + 128])
        srv.step()
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_backpressure_and_recovery():
    srv = DecodeServer(queue_depth=2, slots=8, cache=PlanCache(),
                       device="cpu")
    cfg = DecoderConfig(spec=SPEC)
    sid = srv.open_session(cfg, chunk_frames=2)
    chunk = rx(2 * 64 + SPEC.v2, seed=5)
    srv.push(sid, chunk)
    srv.push(sid, chunk)
    with pytest.raises(Backpressure, match="step"):
        srv.push(sid, chunk)
    srv.step()
    srv.push(sid, chunk)
    srv.close_session(sid)


def test_unknown_session_errors():
    srv = DecodeServer(cache=PlanCache(), device="cpu")
    with pytest.raises(KeyError, match="no live session"):
        srv.push(99, np.zeros((4, 2), np.float32))
    with pytest.raises(KeyError, match="no live session"):
        srv.poll(99)


def test_session_shorter_than_one_chunk():
    cfg = DecoderConfig(spec=SPEC)
    srv = DecodeServer(cache=PlanCache(), device="cpu")
    n = 100
    llr = rx(n, seed=7)
    sid = srv.open_session(cfg, chunk_frames=16)
    srv.push(sid, llr)
    assert srv.poll(sid).size == 0
    got = srv.close_session(sid)[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_metrics_occupancy_and_latency():
    cfg = DecoderConfig(spec=SPEC)
    srv = DecodeServer(slots=4, cache=PlanCache(), device="cpu")
    sid = srv.open_session(cfg, chunk_frames=4)
    srv.push(sid, rx(16 * 64, seed=9))
    srv.drain()
    srv.close_session(sid)
    snap = srv.metrics_snapshot()
    (row,) = snap["buckets"]
    assert row["launches"] == 2 and row["windows"] == 4   # 3 full + tail
    assert row["occupancy"] == 1.0                        # reference: no pad
    assert 0 < row["p50_ms"] <= row["p99_ms"]
    assert snap["totals"]["bits"] == row["bits"] == 16 * 64
    assert snap["plan_cache"]["traces"] >= 1


def test_kernel_backend_bucket_counts_tile_padding():
    """A pinned 8-frame tile under a 2-frame chunk charges 6 padding
    frames per launch, as in the JAX package (whose plan, with the tile
    pinned, has the same fingerprint)."""
    cfg = DecoderConfig(spec=SPEC, backend="kernel", frames_per_tile=8)
    srv = DecodeServer(slots=1, cache=PlanCache(), device="cpu")
    sid = srv.open_session(cfg, chunk_frames=2)
    plan = bucket_plan(cfg, chunk_frames=2, device="cpu")
    assert plan.frames_per_tile == 8
    from repro.serve import bucket_plan as jbucket_plan
    assert plan.fingerprint() == jbucket_plan(
        jcfg(cfg), chunk_frames=2).fingerprint()
    llr = rx(4 * 64, seed=13)
    srv.push(sid, llr)
    srv.drain()
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])
    assert np.array_equal(got, jax_decode(cfg, llr, 4 * 64))
    row = srv.metrics_snapshot()["buckets"][0]
    assert row["pad_frames"] == row["launches"] * 6
    assert row["occupancy"] == pytest.approx(2 / 8)


def test_bucket_plan_matches_stream_default():
    from repro_torch.kernels.autotune import plan_decode
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    plan = bucket_plan(cfg, device="cpu")
    want = plan_decode(STD_K7, SPEC, pack_survivors=cfg.pack_survivors,
                       radix=cfg.radix, bm_dtype=cfg.bm_dtype,
                       layout=cfg.layout, num_devices=1, device="cpu")
    assert plan.cache_key() == want.cache_key()
    assert plan.fingerprint() == want.fingerprint()
    assert len(plan.fingerprint()) == 10
    assert make_stream_decoder(cfg, device="cpu").chunk_frames == \
        plan.chunk_frames


def test_kernel_split_bucket_decodes_through_split_path():
    """A kernel_split session runs the split path's plain versions on the
    CPU (the forward kernel's and the traceback kernel's) and returns the
    JAX package's bits."""
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    cfg = DecoderConfig(spec=SPEC, backend="kernel_split")
    srv = DecodeServer(slots=2, cache=PlanCache(), device="cpu")
    calls = []
    orig = (vf.forward_frames_plain, tbf.traceback_frames_plain)
    try:
        vf.forward_frames_plain = lambda *a, **k: (
            calls.append("fwd"), orig[0](*a, **k))[1]
        tbf.traceback_frames_plain = lambda *a, **k: (
            calls.append("tb"), orig[1](*a, **k))[1]
        sids = [srv.open_session(cfg, chunk_frames=2) for _ in range(2)]
        llrs = [rx(6 * 64, seed=40 + i) for i in range(2)]
        for sid, llr in zip(sids, llrs):
            srv.push(sid, llr)
        srv.drain()
        for sid, llr in zip(sids, llrs):
            got = np.concatenate([srv.poll(sid), srv.close_session(sid)])
            assert np.array_equal(got[:6 * 64], jax_decode(cfg, llr, 6 * 64))
    finally:
        vf.forward_frames_plain, tbf.traceback_frames_plain = orig
    launches = srv.metrics.totals()["launches"]
    assert calls.count("fwd") == calls.count("tb") == launches > 0


def test_mesh_device_and_missing_card(monkeypatch):
    """A mesh must be a FrameMesh (tests/test_torch_distributed.py holds
    the sharded server); the device and the missing card as before."""
    with pytest.raises(TypeError, match="FrameMesh"):
        DecodeServer(mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="FrameMesh"):
        PlanCache().batch_decoder(DecoderConfig(), 4, mesh=object(),
                                  device="cpu")
    srv = DecodeServer(device="cpu")
    assert srv.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanCache().frame_decoder(DecoderConfig())


def test_plan_cache_entries_are_keyed_by_device():
    cache = PlanCache()
    cfg = DecoderConfig(spec=SPEC)
    a = cache.batch_decoder(cfg, 4, device="cpu")
    assert cache.batch_decoder(cfg, 4, device=torch.device("cpu")) is a
    assert cache.stats()["entries"] == 2               # batch + frames
    frames = torch.zeros((4, SPEC.frame_len, 2))
    assert a(frames).shape == (4, SPEC.f)
    a(frames)
    assert cache.stats()["traces"] == 1                # counted once


def test_new_modules_import_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch.core.stream, repro_torch.serve, "
        "repro_torch.serve.checkpoint, repro_torch.obs, "
        "repro_torch.testing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_low_latency_session():
    """Mirrors tests/test_block.py's test of the same name:
    open_session(low_latency=True) engages the auto block policy, lands in
    its own bucket with the plan the JAX server picks, and returns the
    bits of the blocked stream_decode; the sequential session those of the
    plain one; both equal the JAX package's decode (K=7, f=2048, 2 frames,
    chunk_frames=1)."""
    import dataclasses
    spec = FrameSpec(f=2048, v1=32, v2=32)
    cfg = DecoderConfig(spec=spec, backend="kernel")
    n = 2 * spec.f
    llr = rx(n, seed=5, snr=3.0)

    srv = DecodeServer(cache=PlanCache(), device="cpu")
    sid_ll = srv.open_session(cfg, chunk_frames=1, low_latency=True)
    sid_seq = srv.open_session(cfg, chunk_frames=1)
    assert len({s.bucket.id for s in srv._sessions.values()}) == 2
    ll_bucket = srv._sessions[sid_ll].bucket
    assert ll_bucket.decode_cfg.block_frames == "auto"
    jsrv = JDecodeServer(cache=JPlanCache())
    jsid = jsrv.open_session(jcfg(cfg), chunk_frames=1, low_latency=True)
    jplan = jsrv._sessions[jsid].bucket.plan
    assert ll_bucket.plan.block_frames == jplan.block_frames > 1
    assert ll_bucket.plan.overlap == jplan.overlap
    for sid in (sid_ll, sid_seq):
        srv.push(sid, llr)
        while srv.step():
            pass
    got_ll = np.concatenate([srv.poll(sid_ll),
                             srv.close_session(sid_ll)])[:n]
    got_seq = np.concatenate([srv.poll(sid_seq),
                              srv.close_session(sid_seq)])[:n]
    blk_cfg = dataclasses.replace(cfg, block_frames="auto")
    assert np.array_equal(got_ll, jax_decode(blk_cfg, llr, n))
    assert np.array_equal(got_ll, stream_decode(blk_cfg, llr, n,
                                                chunk_frames=1,
                                                device="cpu"))
    assert np.array_equal(got_seq, jax_decode(cfg, llr, n))
