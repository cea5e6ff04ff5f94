"""Multi-tenant Viterbi decode service on the PyTorch port
(repro_torch.serve.DecodeServer).

Opens N sessions across three code configs — the standard K=7 rate-1/2
code, the same code punctured to rate 3/4 (raw punctured pushes, the
server depunctures in-stream), and a K=5 code — streams noisy symbols
chunk by chunk through the slot-based batching server on the card,
verifies every session against its single-stream ``stream_decode``
baseline, and prints the per-bucket occupancy/latency metrics and the
plan cache's stats (one program per bucket shape, whatever the tenant
churn).

  PYTHONPATH=src python examples/torch_serve_viterbi.py --sessions 8 --chunks 6

``--device cpu`` runs the kernels' plain torch versions. The noise comes
from a seeded ``torch.Generator`` per session.

``--chaos`` reruns the same workload under a seeded fault schedule
(repro_torch.testing.faults): injected launch failures, slow launches
tripping the per-launch deadline, forced plan-cache evictions, and one
tenant pushing NaN-poisoned LLRs until it is quarantined. Healthy
sessions must still verify bit-identical.

``--trace-out trace.json`` records the run with the obs tracer and writes
a Chrome trace-event file (open it in https://ui.perfetto.dev).
``--metrics-out PREFIX`` writes the final ``metrics_snapshot()`` as
``PREFIX.prom`` (Prometheus text exposition) and ``PREFIX.json``.

``--checkpoint-dir DIR`` snapshots the whole server to DIR/serve.ckpt
after every round. ``--kill-at-step N`` injects a process 'death' at
server step N and recovers live: the client restores a fresh server from
the last checkpoint, rewinds its own stream positions to the matching
marker and replays; every session still verifies at the end.
``--resume`` restores the server (cumulative metrics and uptime, any
carried-over sessions, which it closes) from DIR/serve.ckpt at start
instead of building a fresh one.

``--block-frames B`` (or ``auto``) switches to one long-frame (f=2048)
tenant config decoded block-parallel: each frame is split into B
overlapped blocks. ``--overlap OV`` sets each block's warm-up/truncation
depth in trellis stages (default: the policy's, ~5 constraint lengths).
``--block-frames 1`` is the sequential baseline of the same workload; the
per-window launch latency is printed either way.

  PYTHONPATH=src python examples/torch_serve_viterbi.py --sessions 2 \\
      --chunks 2 --chunk-frames 2 --block-frames auto
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.channel.sim import awgn, bpsk
from repro_torch.core import DecoderConfig, FrameSpec, encode
from repro_torch.core.puncture import puncture
from repro_torch.core.stream import stream_decode
from repro_torch.core.trellis import make_trellis
from repro_torch.obs import Tracer, set_tracer, write_chrome_trace
from repro_torch.serve import (Backpressure, DecodeServer, PlanCache,
                               SessionQuarantined)
from repro_torch.testing import FaultInjector, FaultSpec
from repro_torch.testing.faults import InjectedCrash


def make_rx(trellis, n, rate, seed, snr=4.0):
    """A session's received stream on the host: (n, beta) soft symbols at
    rate 1/2, the raw punctured stream otherwise."""
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    coded = encode(bits, trellis)
    tx = bpsk(puncture(coded, rate)) if rate != "1/2" else bpsk(coded)
    return awgn(tx, snr, gen).numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=6, help="chunks/session")
    ap.add_argument("--chunk-frames", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chaos", action="store_true",
                    help="run under a seeded fault-injection schedule")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="snapshot the server to DIR/serve.ckpt after "
                         "every round")
    ap.add_argument("--resume", action="store_true",
                    help="restore the server from the checkpoint dir at "
                         "startup (cumulative metrics carry over)")
    ap.add_argument("--kill-at-step", type=int, default=0, metavar="N",
                    help="inject a crash at server step N, then recover "
                         "from the last checkpoint and replay")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--metrics-out", metavar="PREFIX",
                    help="write the final metrics_snapshot as PREFIX.prom "
                         "and PREFIX.json")
    ap.add_argument("--block-frames", default=None, metavar="B|auto",
                    help="intra-frame block-parallel decode: split each "
                         "frame into B overlapped blocks ('auto' lets the "
                         "planner pick); any value switches to a long-frame "
                         "(f=2048) workload, so '1' is the sequential "
                         "baseline of the same workload")
    ap.add_argument("--overlap", type=int, default=None, metavar="OV",
                    help="per-block warm-up/truncation overlap in trellis "
                         "stages (default: policy, ~5 constraint lengths)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    blk = args.block_frames
    if blk is not None and blk != "auto":
        blk = int(blk)
    if args.kill_at_step and not args.checkpoint_dir:
        args.checkpoint_dir = tempfile.mkdtemp(prefix="serve_ckpt_")

    tracer = None
    if args.trace_out:
        tracer = Tracer()
        set_tracer(tracer)          # lights up serve + stream + planner

    k5 = make_trellis(5, (0o23, 0o35))
    spec12 = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    spec34 = FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)
    cfgs = [("K7 r1/2", DecoderConfig(spec=spec12, backend="kernel")),
            ("K7 r3/4", DecoderConfig(spec=spec34, rate="3/4",
                                      backend="kernel")),
            ("K5 r1/2", DecoderConfig(trellis=k5, spec=spec12,
                                      backend="kernel"))]
    if blk is not None:
        # short frames never block (policy threshold), so block mode runs
        # one long-frame tenant config
        spec_long = FrameSpec(f=2048, v1=32, v2=32, f0=32, v2s=32)
        cfgs = [("K7 long", DecoderConfig(spec=spec_long, backend="kernel",
                                          block_frames=blk,
                                          overlap=args.overlap))]

    specs = []
    if args.chaos:
        # the LAST session is the poisoned tenant (sids count from 0)
        specs += [FaultSpec("launch_error", every=5),
                  FaultSpec("launch_slow", every=7, delay_s=0.05),
                  FaultSpec("plan_cache_miss", every=6),
                  FaultSpec("corrupt_llr", every=2, mode="nan",
                            sessions=(args.sessions - 1,))]
    if args.kill_at_step:
        specs.append(FaultSpec("crash_at_step", after=args.kill_at_step,
                               count=1))
    faults = FaultInjector(*specs, seed=3) if specs else None
    cache = PlanCache()
    ck_path = None
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        ck_path = os.path.join(args.checkpoint_dir, "serve.ckpt")
    if args.resume and ck_path and os.path.exists(ck_path):
        srv = DecodeServer.restore(ck_path, cache=cache, faults=faults,
                                   device=dev)
        for sid in list(srv._sessions):
            tail = srv.close_session(sid)
            print(f"resumed: closed carried-over session {sid} "
                  f"({len(tail)} undelivered bits recovered)")
        print(f"resumed from {ck_path}: cumulative uptime "
              f"{srv.metrics_snapshot()['totals']['uptime_s']:.2f}s, "
              f"restore #{srv.checkpoint_restores}")
    else:
        srv = DecodeServer(slots=args.slots, max_sessions=args.sessions,
                           queue_depth=4, cache=cache, faults=faults,
                           launch_timeout_s=0.03 if args.chaos else None,
                           max_retries=1, backoff_s=0.0, quarantine_after=2,
                           device=dev)
    tenants = []
    for i in range(args.sessions):
        name, cfg = cfgs[i % len(cfgs)]
        n = args.chunks * args.chunk_frames * cfg.spec.f
        rx = make_rx(cfg.trellis, n, cfg.rate, seed=i)
        sid = srv.open_session(cfg, chunk_frames=args.chunk_frames)
        per = rx.shape[0] // args.chunks
        tenants.append(dict(sid=sid, name=name, cfg=cfg, rx=rx, n=n,
                            chunks=[rx[j * per:(j + 1) * per]
                                    for j in range(args.chunks)], out=[],
                            quarantined=None))
    print(f"{args.sessions} sessions / {len(srv.buckets())} buckets on "
          f"{dev}, chunk={args.chunk_frames} frames, slots={args.slots}"
          + (", CHAOS schedule on" if args.chaos else ""))

    # client-side recovery marker: (next round, bits delivered per tenant,
    # quarantine states) as of the last checkpoint — on a crash the client
    # rewinds to it and replays against the restored server
    mark = None
    if ck_path:
        srv.checkpoint(ck_path)
        mark = (0, [0] * len(tenants), [None] * len(tenants))
    r = 0
    while r < args.chunks:
        try:
            for t in tenants:
                if t["quarantined"] is not None:
                    continue
                try:
                    srv.push(t["sid"], t["chunks"][r])
                except Backpressure as e:
                    # the structured hint says how many steps clear it
                    for _ in range(e.retry_after_steps or 1):
                        srv.step()
                    srv.push(t["sid"], t["chunks"][r])
                except SessionQuarantined as e:
                    t["quarantined"] = e
            while srv.step():
                pass
            for t in tenants:
                if t["quarantined"] is None:
                    try:
                        t["out"].append(srv.poll(t["sid"]))
                    except SessionQuarantined as e:
                        t["quarantined"] = e
            r += 1
            if ck_path:
                srv.checkpoint(ck_path)
                mark = (r, [sum(len(o) for o in t["out"]) for t in tenants],
                        [t["quarantined"] for t in tenants])
        except InjectedCrash as e:
            print(f"\nCRASH: {e} — restoring a fresh server from {ck_path}")
            srv = DecodeServer.restore(ck_path, cache=cache, faults=faults,
                                       device=dev)
            r, delivered, quar = mark
            for t, nb, q in zip(tenants, delivered, quar):
                acc = (np.concatenate(t["out"]) if t["out"]
                       else np.zeros(0, np.int32))
                t["out"] = [acc[:nb]]
                t["quarantined"] = q
            print(f"restored (restore #{srv.checkpoint_restores}); "
                  f"replaying from round {r}")
    for t in tenants:
        t["out"].append(srv.close_session(t["sid"]))  # quarantined too

    total = 0
    poisoned_sids = {args.sessions - 1} if args.chaos else set()
    for t in tenants:
        if t["sid"] in poisoned_sids:
            continue                      # its input WAS corrupted
        got = np.concatenate(t["out"])[:t["n"]]
        want = stream_decode(t["cfg"], t["rx"], t["n"],
                             chunk_frames=args.chunk_frames, device=dev)
        assert np.array_equal(got, want), f"{t['name']} sid={t['sid']}"
        total += t["n"]

    snap = srv.metrics_snapshot()
    tot = snap["totals"]
    print(f"decoded {total} verified bits in {tot['uptime_s'] * 1e3:.0f} ms "
          f"({tot['mbps']:.2f} Mb/s aggregate) — every healthy session "
          f"bit-identical to its solo stream_decode")
    for t in tenants:
        if t["quarantined"] is not None:
            e = t["quarantined"]
            print(f"quarantined: {t['name']} sid={e.sid} after "
                  f"{e.strikes} poisoned pushes ({e.reason})")
    print(f"{'bucket':<28}{'launches':>9}{'windows':>9}{'occup':>7}"
          f"{'p50 ms':>8}{'p99 ms':>8}{'Mb/s':>7}  {'health':<9}")
    for row in snap["buckets"]:
        print(f"{row['bucket']:<28}{row['launches']:>9}{row['windows']:>9}"
              f"{row['occupancy']:>7.2f}{row['p50_ms']:>8.1f}"
              f"{row['p99_ms']:>8.1f}{row['mbps']:>7.2f}  "
              f"{row['health']:<9}")
    la = snap["stages"].get("launch_ms")
    if la and la.get("count"):
        blocked = blk not in (None, 1)
        mode = (f"block-parallel ({args.block_frames} blocks/frame)"
                if blocked else "sequential scan")
        print(f"per-window launch latency [{mode}]: p50 {la['p50']:.2f} ms, "
              f"p99 {la['p99']:.2f} ms over {la['count']} launches")
    print("plan cache:", snap["plan_cache"])
    if ck_path:
        print(f"checkpoints: {snap['checkpoint']['saves']} saved, "
              f"{snap['checkpoint']['restores']} restores -> {ck_path}")
    if args.chaos:
        print(f"faults recovered: {tot['launch_errors']} launch errors, "
              f"{tot['timeouts']} timeouts, {tot['retries']} retries, "
              f"{tot['degraded']} degraded launches, "
              f"{tot['cache_refreshes']} cache refreshes, "
              f"{tot['sanitized_values']} LLRs sanitized, "
              f"{tot['quarantined']} quarantined — overall "
              f"health={tot['health']}")
    if args.metrics_out:
        from repro_torch.obs import prometheus_text, write_metrics_json
        with open(args.metrics_out + ".prom", "w") as fh:
            fh.write(prometheus_text(snap))
        write_metrics_json(snap, args.metrics_out + ".json")
        print(f"metrics: {args.metrics_out}.prom, {args.metrics_out}.json")
    if tracer is not None:
        obj = write_chrome_trace(tracer, args.trace_out)
        set_tracer(None)
        print(f"trace: {len(obj['traceEvents'])} events -> "
              f"{args.trace_out}")
    return snap


if __name__ == "__main__":
    main()
