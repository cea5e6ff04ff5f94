"""The readers of the program's spans (``portbench.spans`` and the metrics
``sanitize_device_ms``, ``frame_device_ms``, ``plan_ms_per_call``,
``shard_wait_ms``) on hand-built traces: times in microseconds on one
clock, as a profiled slice gives them."""
import dataclasses
import time

import pytest
from portbench_tmp import (BIG_SEED, ROOT, one_thread,  # noqa: F401
                           tiny_benchmark)

from portbench import spans
from portbench.cells import metric_reader
from portbench.harness import Run
from portbench.timeline import DeviceEvent, HostEvent, Trace

NEW = ("sanitize_device_ms", "frame_device_ms", "plan_ms_per_call",
       "shard_wait_ms")


def read(name, trace):
    return metric_reader(ROOT, name).read(Run(None, 0.0, 1.0, [0.0], [0.0],
                                              trace))


def one_card_call(t0, host, ops, extra_launch=False, drop_op=False):
    """A make_decoder call starting at t0: the clip (two kernels), the
    frame (a fill and a copy), the plan, the decode kernel; optionally a
    launch outside every span, and a device operation lost."""
    h = [HostEvent(spans.ISSUE, t0, t0 + 60),
         HostEvent("decode", t0 + 1, t0 + 59),
         HostEvent("decode.sanitize", t0 + 2, t0 + 10),
         HostEvent("cudaLaunchKernel", t0 + 3, t0 + 4),
         HostEvent("cudaLaunchKernel", t0 + 5, t0 + 6),
         HostEvent("decode.frame", t0 + 11, t0 + 20),
         HostEvent("aten::constant_pad_nd", t0 + 11.5, t0 + 15),
         HostEvent("cudaLaunchKernel", t0 + 12, t0 + 13),
         HostEvent("cudaMemcpyAsync", t0 + 14, t0 + 14.5),
         HostEvent("decode.plan", t0 + 21, t0 + 25),
         HostEvent("decode.kernel", t0 + 26, t0 + 40),
         HostEvent("cudaLaunchKernel", t0 + 30, t0 + 31),
         HostEvent(spans.FINISH, t0 + 60, t0 + 100)]
    d = [DeviceEvent(0, "clip_a", t0 + 7, t0 + 9),
         DeviceEvent(0, "clip_b", t0 + 9, t0 + 12),
         DeviceEvent(0, "fill", t0 + 13, t0 + 14),
         DeviceEvent(0, "Memcpy DtoD (Device -> Device)", t0 + 15, t0 + 19),
         DeviceEvent(0, "viterbi_unified_kernel", t0 + 32, t0 + 90)]
    if extra_launch:
        h.append(HostEvent("cudaLaunchKernel", t0 + 50, t0 + 51))
        d.append(DeviceEvent(0, "stray", t0 + 91, t0 + 96))
    if drop_op:
        d.pop(2)
    host += h
    ops += d


def trace(host, ops, devices=(0,)):
    """The slice from just before the first call to the end of the last,
    with the device events that overlap it, as ``from_profile`` keeps."""
    lo, hi = min(h.start for h in host) - 1.0, max(h.end for h in host)
    return Trace([o for o in ops if o.end > lo and o.start < hi], host, lo,
                 hi, list(devices), sum(h.name == spans.ISSUE for h in host),
                 "NVIDIA H100")


def test_ops_go_to_the_innermost_span_over_their_launch():
    host, ops = [], []
    one_card_call(0.0, host, ops)
    one_card_call(200.0, host, ops, extra_launch=True)
    tr = trace(host, ops)
    att = spans.attribute(tr)
    assert (att.calls, att.unpaired) == (2, 0)
    by = {}
    for x in att.launched:
        by.setdefault(x.span, []).append(x.op.name)
    assert by["decode.sanitize"] == ["clip_a", "clip_b"] * 2
    assert by["decode.frame"] == ["fill",
                                  "Memcpy DtoD (Device -> Device)"] * 2
    assert by["decode.kernel"] == ["viterbi_unified_kernel"] * 2
    assert by["decode"] == ["stray"]        # launched in no child span
    assert read("sanitize_device_ms", tr) == pytest.approx(5e-3)
    assert read("frame_device_ms", tr) == pytest.approx(5e-3)


def test_an_op_launched_outside_every_span_counts_nowhere():
    host, ops = [], []
    one_card_call(0.0, host, ops)
    host.append(HostEvent("cudaLaunchKernel", 59.2, 59.6))  # in no span
    ops.append(DeviceEvent(0, "outside", 91.0, 99.0))
    att = spans.attribute(trace(host, ops))
    (outside,) = [x for x in att.launched if x.op.name == "outside"]
    assert outside.span is None
    assert read("sanitize_device_ms", trace(host, ops)) == \
        pytest.approx(5e-3)


def test_a_call_whose_launches_do_not_pair_is_left_out():
    host, ops = [], []
    one_card_call(0.0, host, ops)
    one_card_call(200.0, host, ops, drop_op=True)       # one op lost
    one_card_call(400.0, host, ops)
    tr = trace(host, ops)
    att = spans.attribute(tr)
    assert (att.calls, att.unpaired) == (2, 1)
    # per paired call, not per call of the slice
    assert read("frame_device_ms", tr) == pytest.approx(5e-3)


def test_plan_ms_per_call_is_the_plan_spans_host_time_over_the_calls():
    host, ops = [], []
    for t0 in (0.0, 200.0, 400.0):
        one_card_call(t0, host, ops)
    assert read("plan_ms_per_call", trace(host, ops)) == pytest.approx(4e-3)
    # no device operation: a run on the CPU reads nothing
    assert read("plan_ms_per_call", trace(host, [])) is None


def mesh_call(t0, host, ops, waits):
    """A sharded call over four cards at t0: the frame on card 0, the
    copies out, a decode kernel a card (card c's starting waits[c - 1]
    after its launch) and the copies back under shard.gather."""
    host += [HostEvent(spans.ISSUE, t0, t0 + 100),
             HostEvent("decode.frame", t0 + 1, t0 + 5),
             HostEvent("cudaLaunchKernel", t0 + 2, t0 + 3),
             HostEvent("shard", t0 + 6, t0 + 99),
             HostEvent("shard.out", t0 + 7, t0 + 12)]
    ops += [DeviceEvent(0, "gather", t0 + 2, t0 + 20)]   # the card idle
    for c in (1, 2, 3):
        host.append(HostEvent("cudaMemcpyAsync", t0 + 7 + c, t0 + 7.5 + c))
        ops.append(DeviceEvent(0, "Memcpy PtoP (Device -> Device)",
                               t0 + 14 + 2 * c, t0 + 15 + 2 * c))
    for c in range(4):
        s = t0 + 20 + 10 * c
        host += [HostEvent("shard.decode", s, s + 9),
                 HostEvent("decode.plan", s + 1, s + 3),
                 HostEvent("decode.pad", s + 3, s + 4),
                 HostEvent("decode.kernel", s + 4, s + 8),
                 HostEvent("cudaLaunchKernel", s + 5, s + 6)]
        start = s + 5 + (waits[c - 1] if c else 0)
        ops.append(DeviceEvent(c, "viterbi_unified_kernel", start,
                               start + 2))
    host += [HostEvent("shard.gather", t0 + 61, t0 + 70),
             HostEvent(spans.FINISH, t0 + 100, t0 + 150)]
    for c in range(4):
        host.append(HostEvent("cudaMemcpyAsync", t0 + 62 + c, t0 + 62.5 + c))
        ops.append(DeviceEvent(c, "Memcpy PtoP (Device -> Device)",
                               t0 + 120 + c, t0 + 121 + c))


def test_shard_wait_is_the_mean_over_the_three_cards_past_home():
    host, ops = [], []
    mesh_call(0.0, host, ops, waits=(3.0, 6.0, 9.0))
    mesh_call(300.0, host, ops, waits=(1.0, 2.0, 3.0))
    tr = trace(host, ops, devices=(0, 1, 2, 3))
    att = spans.attribute(tr)
    assert (att.calls, att.unpaired) == (2, 0)
    assert att.shard_waits[0] == [0.0, 3.0, 6.0, 9.0]
    assert read("shard_wait_ms", tr) == pytest.approx((6.0 + 2.0) / 2 * 1e-3)
    assert read("frame_device_ms", tr) == pytest.approx(18e-3)
    assert read("plan_ms_per_call", tr) == pytest.approx(8e-3)
    # the copies back stay unpaired; the copies out fall under shard.out
    assert {x.span for x in att.launched if x.op.name.startswith("Memcpy")} \
        == {"shard.out"}


def shifted(ops, by):
    """The device events moved by ``by`` us against the host's clock."""
    return [DeviceEvent(o.device, o.name, o.start + by, o.end + by)
            for o in ops]


@pytest.mark.parametrize("by", [-30.0, 20.0])
def test_a_device_clock_off_the_hosts_still_pairs(by):
    """Calls of 100 to 150 us on a device clock off the host's by a
    constant. An early clock loses the first call's first operations at
    the slice's start, and that call alone."""
    host, ops = [], []
    for t0 in (0.0, 200.0, 400.0):
        one_card_call(t0, host, ops)
    att = spans.attribute(trace(host, shifted(ops, by)))
    assert (att.calls, att.unpaired) == ((2, 1) if by < 0 else (3, 0))
    mesh_host, mesh_ops = [], []
    for t0 in (0.0, 300.0, 600.0):
        mesh_call(t0, mesh_host, mesh_ops, waits=(3.0, 6.0, 9.0))
    tr = trace(mesh_host, shifted(mesh_ops, by), devices=(0, 1, 2, 3))
    assert spans.attribute(tr).calls == (2 if by < 0 else 3)
    assert read("shard_wait_ms", tr) == pytest.approx(6e-3)


def test_a_drifting_device_clock_is_followed_call_by_call():
    """The offset moves by 40 us a call, more than the room the tracked
    offset leaves at a call's start (an H100 slice drifted 6.4 ms in 1 s,
    16 us a k7 call): each call takes the shift nearest the last one."""
    host, ops = [], []
    for k in range(5):
        call_ops = []
        one_card_call(200.0 * k, host, call_ops)
        ops += shifted(call_ops, -40.0 * k)
    att = spans.attribute(trace(host, ops))
    assert (att.calls, att.unpaired) == (5, 0)
    assert read("sanitize_device_ms", trace(host, ops)) == \
        pytest.approx(5e-3)


def test_a_mesh_call_missing_a_copy_back_is_left_out():
    host, ops = [], []
    mesh_call(0.0, host, ops, waits=(3.0, 6.0, 9.0))
    ops.pop()                                # card 3's copy back lost
    att = spans.attribute(trace(host, ops, devices=(0, 1, 2, 3)))
    assert (att.calls, att.unpaired) == (0, 1)


@pytest.mark.parametrize("name", NEW)
def test_the_readers_find_nothing_without_the_program_spans(name):
    """A trace of a program without the spans (the parent commit), a run
    with no trace, and a trace with no device event read None."""
    host, ops = [], []
    one_card_call(0.0, host, ops)
    bare = [h for h in host if not spans.is_program_span(h.name)]
    assert read(name, trace(bare, ops)) is None
    assert read(name, None) is None
    assert read(name, trace(host, [])) is None


def test_the_traced_slice_of_a_cpu_run_carries_the_program_spans(
        tmp_path, monkeypatch):
    """The harness's profiled slice, unchanged, holds the decode path's
    spans once a profiler records; the plan's host time reads from them
    where the trace has a device event."""
    from portbench import harness, timeline
    root = tiny_benchmark(tmp_path)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    kept = []
    real = timeline.from_profile

    def keep(*a, **kw):
        kept.append(real(*a, **kw))
        return kept[-1]
    monkeypatch.setattr(timeline, "from_profile", keep)
    result, _ = harness.run_cell(root, "tiny_k7", BIG_SEED, 0.2, True,
                                 ["cpu"], time.perf_counter(),
                                 log=lambda s: None)
    assert result["correct"] is True
    (tr,) = kept
    inside = [h for h in tr.host if tr.lo <= h.start <= tr.hi]
    names = {h.name for h in inside}
    assert {"decode", "decode.copy_in", "decode.sanitize", "decode.frame",
            "decode.plan", "decode.pad", "decode.kernel"} <= names
    calls = sum(h.name == "decode" for h in inside)
    assert calls == tr.calls
    on_card = dataclasses.replace(
        tr, events=[DeviceEvent(0, "viterbi_unified_kernel", tr.lo, tr.hi)])
    plan = read("plan_ms_per_call", on_card)
    assert plan == pytest.approx(sum(h.end - h.start for h in inside
                                     if h.name == "decode.plan")
                                 / calls * 1e-3)
    assert plan > 0
