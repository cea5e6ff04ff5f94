"""The port's fault tolerance (repro_torch.testing.faults, input
sanitization, retry/degrade, quarantine) against the JAX package's, on
the CPU.

Mirrors tests/test_faults.py. The fault injector is numpy, copied: the
same specs, seed and call order give the same schedule and the same
corrupted arrays, byte for byte, in both packages. A faulted server run
with the same schedule returns the JAX server's bits and counters. The
port adds one rule of its own: a CUDA error is sticky, so the retry and
degrade machinery lets it propagate. Tolerance 0 throughout.
"""
import dataclasses

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_parity import counters, jax_decode, jcfg, rx
from repro.serve import DecodeServer as JDecodeServer
from repro.serve import PlanCache as JPlanCache
from repro.testing import faults as jfaults

from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.sanitize import sanitize_llr
from repro_torch.core.stream import make_stream_decoder, stream_decode
from repro_torch.serve import (Backpressure, DecodeServer, PlanCache,
                               PoisonedInput, ServeError, ServerFull,
                               SessionQuarantined)
from repro_torch.testing import faults as tfaults
from repro_torch.testing import (FaultInjector, FaultSpec,
                                 InjectedKernelError)

SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)


def _poison(llr, rng, mode, frac=0.2):
    out = np.array(llr, np.float32)
    flat = out.reshape(-1)
    k = max(1, int(frac * flat.size))
    idx = rng.choice(flat.size, size=k, replace=False)
    flat[idx] = {"nan": np.nan, "inf": np.inf, "huge": 1e30}[mode]
    if mode != "nan":
        flat[idx[1::2]] *= -1.0
    return out


# ------------------------------------------------------ the injector itself
_SCHEDULE = [
    dict(kind="launch_error", p=0.3),
    dict(kind="launch_error", every=4),
    dict(kind="device_loss", after=3, count=2, bucket="K7"),
    dict(kind="corrupt_llr", p=0.5, mode="huge", frac=0.1),
    dict(kind="corrupt_llr", every=3, mode="inf", sessions=(1,)),
    dict(kind="plan_cache_miss", p=0.4),
    dict(kind="crash_at_step", after=5, count=1),
    dict(kind="checkpoint_corrupt", every=2),
]


def _drive(mod, seed):
    """One fixed call sequence through every hook; returns everything the
    injector produced (raised kinds, arrays, flags, stats)."""
    inj = mod.FaultInjector(*[mod.FaultSpec(**d) for d in _SCHEDULE],
                            seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(12):
        try:
            inj.launch("K7-f64" if i % 2 else "K5-f64")
            out.append("ok")
        except mod.InjectedFault as e:
            out.append(type(e).__name__)
        arr = rng.standard_normal((16, 2)).astype(np.float32)
        got = inj.corrupt(arr, sid=i % 3)
        out.append(np.asarray(got, np.float32).tobytes())
        out.append(inj.plan_cache_miss())
        try:
            inj.crash()
            out.append("alive")
        except mod.InjectedCrash:
            out.append("crash")
        out.append(inj.checkpoint_bytes(bytes(range(40))))
    out.append(inj.stats())
    return out


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_injector_schedule_and_corruption_equal_jax(seed):
    assert _drive(tfaults, seed) == _drive(jfaults, seed)


def test_fault_spec_validation_and_kinds_equal_jax():
    assert tfaults.KINDS == jfaults.KINDS
    for bad in (dict(kind="meteor"), dict(kind="corrupt_llr", mode="x"),
                dict(kind="launch_error", p=2.0)):
        msgs = []
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError) as e:
                mod.FaultSpec(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- sanitize
@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from(["nan", "inf", "huge"]))
def test_stream_push_poisoned_equals_sanitized_stream(seed, mode):
    """StreamDecoder.push sanitizes at the boundary: a poisoned chunk
    decodes like the pre-sanitized stream (and like the JAX decoder of
    it), and the counters record what was scrubbed."""
    rng = np.random.default_rng(seed)
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    n = 12 * SPEC.f
    llr = rx(n, seed=seed % 997, snr=3.0)
    bad = llr.copy()
    bad[: 4 * SPEC.f] = _poison(llr[: 4 * SPEC.f], rng, mode)
    clean, n_bad = sanitize_llr(bad)
    assert n_bad > 0
    dec = make_stream_decoder(cfg, chunk_frames=4, device="cpu")
    out = [dec.push(bad[i: i + 4 * SPEC.f])
           for i in range(0, n, 4 * SPEC.f)]
    assert dec.numeric_stats()["sanitized_values"] == n_bad
    out.append(dec.flush())
    got = np.concatenate(out)[:n]
    assert np.array_equal(got, jax_decode(cfg, clean, n))
    assert np.array_equal(got, make_decoder(cfg, "cpu")(bad, n).numpy())


def test_stream_push_rejects_malformed_shapes():
    cfg = DecoderConfig(spec=SPEC)
    dec = make_stream_decoder(cfg, chunk_frames=4, device="cpu")
    assert dec.push(np.zeros((0, 2), np.float32)).size == 0
    with pytest.raises(ValueError, match="flat or"):
        dec.push(np.zeros((2, 3, 2), np.float32))
    with pytest.raises(ValueError):
        dec.push(np.zeros((5, 3), np.float32))
    n = 6 * SPEC.f
    llr = rx(n, seed=3)
    got = np.concatenate([dec.push(llr), dec.flush()])[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


# ------------------------------------------------------- error hierarchy
def test_serve_error_hierarchy_and_retry_hint():
    for exc in (ServerFull, Backpressure, PoisonedInput,
                SessionQuarantined):
        assert issubclass(exc, ServeError)
    assert issubclass(ServeError, RuntimeError)
    srv = DecodeServer(slots=1, max_sessions=1, queue_depth=2, device="cpu")
    sid = srv.open_session(DecoderConfig(spec=SPEC), chunk_frames=2)
    with pytest.raises(ServerFull, match="max_sessions") as ei:
        srv.open_session(DecoderConfig(spec=SPEC))
    assert ei.value.retry_after_steps is None
    with pytest.raises(Backpressure, match="step") as ei:
        srv.push(sid, np.zeros((20 * SPEC.f, 2), np.float32))
    assert isinstance(ei.value.retry_after_steps, int)
    srv.push(sid, np.zeros((4 * SPEC.f, 2), np.float32))
    with pytest.raises(Backpressure, match="split") as ei:
        srv.push(sid, np.zeros((4 * SPEC.f, 2), np.float32))
    for _ in range(ei.value.retry_after_steps):
        srv.step()
    srv.push(sid, np.zeros((4 * SPEC.f, 2), np.float32))


# ------------------------------------------------------- server hardening
def test_server_quarantines_poison_keeps_healthy_tenant_bit_exact():
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    n = 12 * SPEC.f
    healthy = rx(n, seed=4, snr=3.0)
    srv = DecodeServer(slots=2, cache=PlanCache(), quarantine_after=2,
                       device="cpu")
    bad_sid = srv.open_session(cfg, chunk_frames=4)
    ok_sid = srv.open_session(cfg, chunk_frames=4)
    per = 4 * SPEC.f
    raised = []
    for r in range(3):
        try:
            srv.push(bad_sid, np.full((per, 2), np.nan, np.float32))
        except SessionQuarantined as e:
            raised.append(e)
        srv.push(ok_sid, healthy[r * per:(r + 1) * per])
        while srv.step():
            pass
    assert len(raised) == 1 and raised[0].sid == bad_sid
    assert raised[0].strikes == 2 and raised[0].retry_after_steps is None
    with pytest.raises(SessionQuarantined):
        srv.poll(bad_sid)
    snap = srv.metrics_snapshot()
    assert snap["quarantined_sessions"] == 1
    assert snap["totals"]["quarantined"] == 1
    assert snap["totals"]["sanitized_values"] >= 2 * per * 2
    assert snap["totals"]["health"] == "impaired"
    got = np.concatenate([srv.poll(ok_sid), srv.close_session(ok_sid)])[:n]
    assert np.array_equal(got, jax_decode(cfg, healthy, n))
    bits = srv.close_session(bad_sid)
    assert bits.dtype == np.int32 and srv.num_sessions == 0


def test_server_raise_policy_rejects_without_absorbing():
    cfg = DecoderConfig(spec=SPEC)
    srv = DecodeServer(cache=PlanCache(), sanitize="raise", device="cpu")
    sid = srv.open_session(cfg, chunk_frames=4)
    n = 6 * SPEC.f
    llr = rx(n, seed=5, snr=3.0)
    bad = llr.copy()
    bad[0, 0] = np.inf
    with pytest.raises(PoisonedInput, match="non-finite"):
        srv.push(sid, bad)
    srv.push(sid, llr)
    got = srv.close_session(sid)[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def _faulted(srv_cls, cache, cfg, faults, n_chunks=3, **kw):
    n = n_chunks * 4 * SPEC.f
    llr = rx(n, seed=6, snr=3.0)
    srv = srv_cls(slots=2, cache=cache, faults=faults, backoff_s=0.0, **kw)
    sid = srv.open_session(cfg, chunk_frames=4)
    per = 4 * SPEC.f
    for r in range(n_chunks):
        srv.push(sid, llr[r * per:(r + 1) * per])
        while srv.step():
            pass
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])[:n]
    return got, llr, srv


@pytest.mark.parametrize("spec,kw", [
    (dict(kind="launch_error", every=1), dict(max_retries=1)),
    (dict(kind="launch_error", p=0.5), dict(max_retries=2)),
    # the deadline far above any unfaulted launch or read-back on a loaded
    # CPU, the injected hang far above the deadline: the timeouts counted
    # are the injected ones on both sides, whatever the machine's load
    (dict(kind="launch_slow", every=1, delay_s=1.0),
     dict(max_retries=0, launch_timeout_s=0.5)),
    (dict(kind="plan_cache_miss", every=2), {}),
])
def test_faulted_server_equals_jax(spec, kw):
    """Retries exhausted -> the reference fallback; deadline timeouts;
    forced plan-cache rebuilds: under one seeded schedule the port's bits
    and counters are the JAX server's (the JAX side on its reference
    backend, whose fallback program is its primary one, so the plan cache
    is compared only where no launch degrades)."""
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    got, llr, srv = _faulted(DecodeServer, PlanCache(), cfg,
                             FaultInjector(FaultSpec(**spec), seed=3),
                             device="cpu", **kw)
    jgot, _, jsrv = _faulted(JDecodeServer, JPlanCache(),
                             jcfg(cfg, backend="reference"),
                             jfaults.FaultInjector(
                                 jfaults.FaultSpec(**spec), seed=3), **kw)
    assert np.array_equal(got, jax_decode(cfg, llr, got.shape[0]))
    assert np.array_equal(got, jgot)
    mine, theirs = counters(srv.metrics_snapshot()), counters(
        jsrv.metrics_snapshot())
    for c in (mine, theirs):
        c["totals"] = {k: v for k, v in c["totals"].items()
                       if k not in ("pad_frames", "occupancy")}
        if c["totals"]["degraded"]:
            del c["plan_cache"]
    assert mine == theirs
    tot = srv.metrics.totals()
    if spec["kind"] == "launch_error":
        assert tot["launch_errors"] == mine["faults"]["injected"][
            "launch_error"]
        assert tot["retries"] == tot["launch_errors"] - tot["degraded"]
    if spec["kind"] == "launch_slow":
        assert tot["timeouts"] >= 1 and tot["launch_errors"] == 0
    if spec["kind"] == "plan_cache_miss":
        assert tot["cache_refreshes"] >= 1 and tot["degraded"] == 0


def test_stream_decoder_fault_propagates_no_retry():
    faults = FaultInjector(FaultSpec("launch_error", every=1), seed=0)
    dec = make_stream_decoder(DecoderConfig(spec=SPEC), chunk_frames=4,
                              faults=faults, device="cpu")
    with pytest.raises(InjectedKernelError):
        dec.push(rx(8 * SPEC.f, seed=7))


def _server_failing_with(message):
    """A server whose bucket launches raise RuntimeError(message); the
    reference fallback still works. Returns (server, session)."""
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    srv = DecodeServer(slots=2, cache=PlanCache(), backoff_s=0.0,
                       device="cpu")
    sid = srv.open_session(cfg, chunk_frames=2)
    bucket = srv._sessions[sid].bucket
    orig = srv.cache.batch_decoder

    def failing(c, nframes, **kw):
        if c == bucket.decode_cfg:
            def run(frames):
                raise RuntimeError(message)
            return run
        return orig(c, nframes, **kw)

    srv.cache.batch_decoder = failing
    srv.push(sid, rx(3 * 64, seed=8))           # one complete window
    return srv, sid


@pytest.mark.parametrize("message", [
    "viterbi_unified launch failed: CUDA error 700",
    "CUDA error: an illegal memory access was encountered"])
def test_cuda_error_is_not_retried_or_degraded(message):
    """A CUDA error is sticky: the server lets it propagate instead of
    retrying or degrading in-process."""
    srv, _ = _server_failing_with(message)
    with pytest.raises(RuntimeError, match="CUDA error"):
        srv.step()
    tot = srv.metrics.totals()
    assert tot["launch_errors"] == tot["retries"] == tot["degraded"] == 0


def test_other_launch_errors_are_retried_then_degraded():
    srv, sid = _server_failing_with("a recoverable launch failure")
    assert srv.step() == 1
    tot = srv.metrics.totals()
    assert tot["launch_errors"] == srv.max_retries + 1
    assert tot["retries"] == srv.max_retries and tot["degraded"] == 1
    data = rx(3 * 64, seed=8)
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])[:3 * 64]
    assert np.array_equal(got, jax_decode(DecoderConfig(spec=SPEC), data,
                                          3 * 64))


# ------------------------------------------------------- renormalization
def test_renorm_every_bit_identical_on_clean_long_stream():
    cfg = DecoderConfig(spec=SPEC)
    n = 48 * SPEC.f
    llr = rx(n, seed=10, snr=2.0)
    want = stream_decode(cfg, llr, n, chunk_frames=16, device="cpu")
    assert np.array_equal(want, jax_decode(cfg, llr, n))
    for every in (0, 7):
        got = stream_decode(dataclasses.replace(cfg, renorm_every=every),
                            llr, n, chunk_frames=16, device="cpu")
        assert np.array_equal(got, want), f"renorm_every={every}"
