"""call_roofline's counts against hand-worked numbers, the statistics
over all samples, the sample of calls the check compares, and the idle
share from a synthetic timeline."""
import math

import pytest
from portbench_tmp import ROOT, one_thread  # noqa: F401

from portbench.cells import load_cell, load_module
from portbench.harness import SAMPLE_CALLS, Kept, Run, _breakdown
from portbench.timeline import DeviceEvent, HostEvent, Trace, gaps, union_us

H100 = "NVIDIA H100 80GB HBM3"
roof = load_module(ROOT, "metrics", "call_roofline")


def test_k7_counts_and_bound():
    cell = load_cell(ROOT, "k7_r12_batch")
    ops, nbytes = roof.call_work(cell.config, 1 << 24)
    assert ops == 6 * 64 * 65536 * 321 == 8_078_229_504
    assert nbytes == (1 << 24) * (2 * 4 + 4) == 201_326_592
    t, by = roof.least_seconds(cell.config, 1 << 24, H100)
    assert by == "operations" and t * 1e3 == pytest.approx(0.12057, rel=1e-4)
    assert round(t * 1e3, 3) == 0.121


def test_galileo_counts_and_bound():
    cfg = load_cell(ROOT, "k7_r12_batch").config
    cfg = {**cfg, "code": {"k": 15, "rate": "1/4", "generators_octal":
                           ["46321", "51271", "63667", "70535"]}}
    ops, nbytes = roof.call_work(cfg, 1 << 20)
    assert ops == 6 * 16384 * 4096 * 321
    assert nbytes == (1 << 20) * (4 * 4 + 4)
    t, by = roof.least_seconds(cfg, 1 << 20, H100)
    assert by == "operations" and round(t * 1e3, 2) == 1.93


def test_a_partial_last_frame_counts_whole():
    cfg = load_cell(ROOT, "k7_r12_batch").config
    ops, _ = roof.call_work(cfg, 257)
    assert ops == 6 * 64 * 2 * 321


def _trace(events, calls=2, lo=0.0, hi=100.0, devices=(0,), kind=H100):
    return Trace(list(events), [], lo, hi, list(devices), calls, kind)


def test_roofline_reads_kernels_not_copies_and_stays_under_100():
    cell = load_cell(ROOT, "k7_r12_batch")
    least, _ = roof.least_seconds(cell.config, cell.n, H100)
    us = least * 1e6
    ev = [DeviceEvent(0, "void viterbi_unified_kernel<4, 2>", 0, us),
          DeviceEvent(0, "index_kernel", us, 2 * us),
          DeviceEvent(0, "Memcpy HtoD (Pinned -> Device)", 0, 50 * us)]
    run = Run(cell, 1.0, 1.0, [1.0], [1.0], _trace(ev, calls=1))
    assert roof.read(run) == pytest.approx(50.0)
    run.trace = _trace([], calls=1)
    assert roof.read(run) is None
    run.trace = _trace(ev, calls=1, kind="a card with no table entry")
    assert roof.read(run) is None


def test_per_call_device_readers():
    cell = load_cell(ROOT, "k7_r12_batch")
    ev = [DeviceEvent(0, "void viterbi_unified_kernel<4, 2>", 0, 30),
          DeviceEvent(0, "elementwise_kernel", 30, 40),
          DeviceEvent(0, "Memset (Device)", 40, 42),
          DeviceEvent(0, "Memcpy HtoD (Pinned -> Device)", 50, 70),
          DeviceEvent(1, "Memcpy PtoP (Device -> Device)", 0, 6)]
    run = Run(cell, 1.0, 1.0, [1.0], [1.0], _trace(ev, devices=(0, 1)))
    read = lambda m: load_module(ROOT, "metrics", m).read(run)
    assert read("glue_device_ms") == pytest.approx(5e-3)
    assert read("h2d_ms_per_call") == pytest.approx(10e-3)
    assert read("peer_copy_ms_per_call") == pytest.approx(3e-3)
    # busy 0-42, 50-70 on card 0 (62 %), 0-6 on card 1 (6 %)
    assert read("device_idle_pct") == pytest.approx(100 - (62 + 6) / 2)
    run.trace = _trace(ev[1:], devices=(0, 1))
    assert read("glue_device_ms") is None          # no decode kernel seen
    run.trace = None
    assert read("glue_device_ms") is None and read("device_idle_pct") is None


def test_host_clock_readers():
    cell = load_cell(ROOT, "k7_r12_batch")
    lat = [0.001 * (i + 1) for i in range(100)]      # 1 .. 100 ms
    run = Run(cell, 7.5, 2.0, lat, [0.0005] * 100)
    read = lambda m: load_module(ROOT, "metrics", m).read(run)
    assert read("latency_ms_p95") == pytest.approx(95.05)
    assert read("decoded_mbps") == pytest.approx(100 * (1 << 24) / 2.0 / 1e6)
    assert read("host_ms_per_call") == pytest.approx(0.5)
    assert read("setup_s") == 7.5


def test_p95_is_taken_over_all_samples():
    cell = load_cell(ROOT, "k7_r12_batch")
    p95 = lambda xs: load_module(ROOT, "metrics", "latency_ms_p95").read(
        Run(cell, 1.0, 1.0, xs, xs))
    xs = [1e-3 * x for x in range(1, 21)]           # 1 .. 20 ms
    assert p95(xs) == pytest.approx(19.05)
    assert p95(xs[::-1]) == p95(xs)
    assert p95([4e-3]) == pytest.approx(4.0)
    # one slow call in twenty moves the tail: no sample is dropped
    assert p95(xs[:-1] + [1.0]) == pytest.approx(19.0 + 0.05 * 981)


def _sampled(calls, pool=4, seed=1234):
    """The (slot -> call index) that ``Kept`` holds after ``calls``
    calls taking the pool's blocks in turn."""
    kept = Kept(pool, seed)
    for i in range(calls):
        p = i % pool
        kept.keep(kept.slot(p), p, i)
    return {s: out for s, (p, out) in kept.outs.items()}


def test_the_check_samples_calls_over_the_whole_window():
    held = _sampled(20000)
    assert held[4] == 0                            # the first call
    sample = sorted(v for s, v in held.items() if s > 4)
    assert len(sample) == SAMPLE_CALLS == len(set(sample))
    assert sample[0] < 5000 and sample[-1] > 15000  # spread, not the first
    quarters = {v * 4 // 20000 for v in sample}
    assert quarters == {0, 1, 2, 3}
    # the last call of each block that no sample slot took
    assert all(held[p] % 4 == p and held[p] >= 20000 - 4 * 40
               for p in range(4))
    assert _sampled(20000) == held                  # drawn from the seed
    assert _sampled(20000, seed=99) != held
    # a short window keeps every call
    assert sorted(_sampled(SAMPLE_CALLS + 1).values()) == list(
        range(SAMPLE_CALLS + 1))


def test_idle_share_from_a_synthetic_timeline():
    iv = [(10, 20), (15, 30), (50, 60), (95, 120)]
    assert union_us(iv, 0, 100) == 20 + 10 + 5
    assert gaps(iv, 0, 100) == [(0, 10), (30, 50), (60, 95)]
    assert gaps([], 0, 10) == [(0, 10)]
    assert union_us([], 0, 10) == 0
    ev = [DeviceEvent(0, "k", s, e) for s, e in iv]
    tr = Trace(ev, [HostEvent("portbench.finish", 25, 100),
                    HostEvent("cudaEventSynchronize", 30, 99),
                    HostEvent("portbench.issue", 0, 25)], 0, 100, [0], 1, H100)
    assert tr.busy_us(0) == 35
    bd = _breakdown(tr)
    assert bd["device_ops"] == [["k", pytest.approx(60e-6)]]
    idle = dict((k, v) for k, v in bd["idle_gaps"])
    assert idle["cudaEventSynchronize"] == pytest.approx(55e-6)
    assert idle["portbench.issue"] == pytest.approx(10e-6)
    assert math.isclose(sum(idle.values()) * 1e6, 100 - 35)
