#!/usr/bin/env python3
"""Break a benchmark cell's traced slice down by the port's spans, hold the
benchmark's pairing of launches and device operations against the
profiler's correlation ids, and time what the spans cost.

    python3 tools/span_breakdown.py --workload k7_r12_batch --seed N \
        [--turns 2] [--json PATH]

Builds the cell's client as ``portbench/run.py`` does (inputs from the
seed, one warm call a pool block), then runs, in turns (ABCCBA, ``--turns``
times), profiled slices of ``harness.TRACE_SECONDS`` each:

* ``off``: ``set_tracer(NullTracer())``, so no span reaches the profiler
  (the decode path as it was before its spans);
* ``spans``: no tracer set, so the spans land in the profiler alone (what
  the benchmark's ``--trace 1`` slice records);
* ``ring``: ``ProfiledTracer``, the ring and the profiler;

and unprofiled windows of the same length with no tracer (``null``) and
with ``ProfiledTracer`` set (``ring_noprof``). Prints the calls a second
of each, and each ``spans`` slice's paired and unpaired calls
(``portbench.spans``). For the last ``spans`` slice it
prints the device milliseconds a call under each program span by the
benchmark's pairing and by the profiler's correlation ids, the share of
paired operations whose launch and span the two agree on, the device
time launched outside every span, the benchmark's per-layer metrics of
this tree and the idle gaps by host event (``harness._breakdown``).
Writes it all as JSON to ``--json`` (default
``build/spans/<cell>_<seed>.json``).
Needs the cell's cards; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MODES = ("off", "spans", "ring")


def _truth(prof, lo: float, hi: float, spans) -> dict:
    """Each device operation in [lo, hi] (keyed by device, start) to
    (launch start, innermost program span over its launch) by the
    profiler's correlation ids: a device event's id is its runtime
    call's."""
    from torch.autograd import DeviceType

    from portbench.spans import _covering, launch_kind
    runtime = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and launch_kind(ev.name):
            runtime.setdefault(ev.id, []).append(ev)
    out = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation or \
                ev.name.startswith("portbench."):
            continue
        s = ev.time_range.start
        if not (lo <= s <= hi):
            continue
        calls = runtime.get(ev.id, [])
        if not calls:
            out[(int(ev.device_index), s)] = (None, None)
            continue
        t = calls[0].time_range.start
        over = _covering(spans, t)
        out[(int(ev.device_index), s)] = (t, over[-1].name if over else None)
    return out


def _slice(client, inputs, kept, devices, mode: str, seconds: float,
           profiled: bool):
    """(calls a second, Trace, profile) of one slice in ``mode``; the
    trace and profile are None unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness, timeline
    from repro_torch import obs
    tracer = {"off": obs.NullTracer(), "spans": None, "null": None,
              "ring": obs.ProfiledTracer(),
              "ring_noprof": obs.ProfiledTracer()}[mode]
    prev = obs.set_tracer(tracer)
    try:
        if not profiled:
            window, lat, _ = harness._loop(client, inputs, seconds, kept)
            return len(lat) / window, None, None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(harness.WINDOW_SPAN):
                window, lat, _ = harness._loop(client, inputs, seconds,
                                               kept, traced=True)
    finally:
        obs.set_tracer(prev)
    idx = sorted({torch.device(d).index or 0 for d in devices})
    tr = timeline.from_profile(prof, harness.WINDOW_SPAN, idx, len(lat),
                               torch.cuda.get_device_name(devices[0]))
    return len(lat) / window, tr, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spans
    from portbench.cells import load_benchmark, load_cell, metric_reader, \
        metrics_of
    cell = load_cell(ROOT, args.workload)
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    inputs = harness.make_inputs(cell, args.seed, torch.device(devices[0]))
    kept = harness.Kept(len(inputs.order), args.seed)
    client = harness.make_client(cell, inputs, devices, kept.slots)
    for p in range(len(inputs.order)):
        client.finish(client.issue(p), p)
    for d in devices:
        torch.cuda.synchronize(d)

    secs = harness.TRACE_SECONDS
    rates = {m: [] for m in MODES + ("null", "ring_noprof")}
    last, sessions = None, []
    for _ in range(args.turns):
        for mode in MODES + MODES[::-1]:
            rate, tr, prof = _slice(client, inputs, kept, devices, mode,
                                    secs, True)
            rates[mode].append(rate)
            if mode == "spans":
                last = (tr, prof)
                a = spans.attribute(tr)
                sessions.append([a.calls, a.unpaired])
            del prof
        for mode in ("null", "ring_noprof", "ring_noprof", "null"):
            rates[mode].append(_slice(client, inputs, kept, devices,
                                      mode, secs, False)[0])
    tr, prof = last
    att = spans.attribute(tr)
    if att is None:
        print("the spans slice holds no device operation or no program "
              f"span; calls a second: {json.dumps(rates)}", file=sys.stderr)
        return 1
    host = sorted((h for h in tr.host if tr.lo <= h.start <= tr.hi),
                  key=lambda h: h.start)
    prog = [h for h in host if spans.is_program_span(h.name)]
    truth = _truth(prof, tr.lo, tr.hi, prog)

    by_pair, by_truth, agree, total_us, outside_us = {}, {}, 0, 0.0, 0.0
    for x in att.launched:
        t_launch, t_span = truth.get((x.op.device, x.op.start), (None, None))
        agree += (t_launch is not None and abs(t_launch - x.launch.start)
                  < 1e-3 and t_span == x.span)
        by_pair[x.span] = by_pair.get(x.span, 0.0) + x.op.us
    ops = {(e.device, e.start): e for e in tr.events}
    for key_op, (t, span) in truth.items():
        ev = ops.get(key_op)
        if ev is None:
            continue
        key = span if t is not None else "(no runtime call)"
        by_truth[key] = by_truth.get(key, 0.0) + ev.us
        total_us += ev.us
        if t is None or span is None:
            outside_us += ev.us
    per_call = lambda d, n: {str(k): v / n * 1e-3 for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])}
    peer = sum(e.us for e in tr.events if e.name.startswith("Memcpy PtoP"))
    decode_k = sum(e.us for e in tr.events
                   if any(k in e.name for k in ("viterbi_unified",
                                                "viterbi_fwd",
                                                "traceback_frames")))
    first = []
    issues = [h for h in host if h.name == spans.ISSUE]
    if issues:
        i0 = issues[len(issues) // 2]
        f0 = next(h for h in host if h.name == spans.FINISH and
                  h.start >= i0.start)
        first = [[h.name, round(h.start - i0.start, 3)] for h in host
                 if i0.start <= h.start <= f0.end and
                 (spans.launch_kind(h.name) or
                  spans.is_program_span(h.name))]
        first += [[f"dev{e.device}:{e.name[:60]}", round(e.start - i0.start,
                                                          3)]
                  for e in tr.events if i0.start <= e.start <= f0.end]
    bench = load_benchmark(ROOT)
    metrics = {}
    run = harness.Run(cell, 0.0, 1.0, [0.0], [0.0], tr)
    for m in metrics_of(bench, args.workload, "per_layer"):
        metrics[m["name"]] = metric_reader(ROOT, m["name"]).read(run)
    out = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(devices[0]),
        "torch": torch.__version__,
        "calls_per_s": rates,
        "calls_per_s_median": {m: statistics.median(v)
                               for m, v in rates.items()},
        "slice_calls": tr.calls, "paired_calls": att.calls,
        "unpaired_calls": att.unpaired,
        "spans_slices_paired_unpaired": sessions,
        "agree_share": agree / max(len(att.launched), 1),
        "paired_ops": len(att.launched), "ops": len(tr.events),
        "device_ms_per_call_by_pairing": per_call(by_pair, att.calls),
        "device_ms_per_call_by_correlation": per_call(by_truth, tr.calls),
        "outside_spans_share": outside_us / max(total_us, 1e-9),
        "non_decode_non_peer_ms_per_call":
            (sum(e.us for e in tr.events) - decode_k - peer) / tr.calls
            * 1e-3,
        "metrics": metrics,
        "breakdown": harness._breakdown(tr),
        "one_call": first,
    }
    path = Path(args.json or ROOT / "build" / "spans" /
                f"{args.workload}_{args.seed}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    for k in ("calls_per_s_median", "slice_calls", "paired_calls",
              "unpaired_calls", "spans_slices_paired_unpaired",
              "agree_share", "outside_spans_share",
              "device_ms_per_call_by_pairing",
              "device_ms_per_call_by_correlation",
              "non_decode_non_peer_ms_per_call", "metrics"):
        print(f"{k}: {json.dumps(out[k])}")
    print("idle_gaps:", json.dumps(out["breakdown"]["idle_gaps"]))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
