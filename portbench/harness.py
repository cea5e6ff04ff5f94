"""One run of one cell: inputs from the seed, warm-up, the closed-loop
window, the traced slice, the check against the reference, the result.

``run_cell`` does everything but the look for a card, so the tests drive
it on the CPU at small sizes; ``run.py`` looks for the card first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import time

import numpy as np
import torch

from portbench import timeline
from portbench.cells import Cell, load_benchmark, load_cell, load_module, \
    metric_reader, metrics_of
from portbench.reference import channel

__all__ = ["Inputs", "Run", "Kept", "make_inputs", "make_client",
           "check_outputs", "run_cell", "WINDOW_SPAN", "TRACE_SECONDS",
           "SAMPLE_CALLS"]

#: The host span around the traced slice.
WINDOW_SPAN = "portbench.window"
#: Seconds of the profiled slice that follows the window in a traced run.
TRACE_SECONDS = 1.0
#: Calls whose bits are compared besides the first call and the last call
#: of every pool block: a uniform sample of the window's calls.
SAMPLE_CALLS = 32
#: Entries of a breakdown list, and the longest name kept.
BREAKDOWN_TOP = 10
NAME_CHARS = 120
_NOSPAN = contextlib.nullcontext()


@dataclasses.dataclass
class Inputs:
    """The pool a cell's client draws its calls from, made on ``device``:
    LLRs (P, n, beta), the information bits they carry (P, n) and the
    order in which the calls take the blocks."""
    llr: torch.Tensor
    bits: torch.Tensor
    order: list


@dataclasses.dataclass
class Run:
    """What the metrics read: the cell, the set-up time, the window's
    length and per-call samples (host seconds until the call returned and
    until its bits were ready) and, in a traced run, the trace."""
    cell: Cell
    setup_s: float
    window_s: float
    latency_s: list
    host_s: list
    trace: timeline.Trace | None = None

    @property
    def calls(self) -> int:
        return len(self.latency_s)


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """The cell's pool from ``seed``: every block of the same size, the
    order a permutation drawn from the seed."""
    k, polys, _ = cell.code
    pool = int(cell.traffic["pool"])
    gen = channel.generator(seed, device)
    bits = channel.info_bits(gen, (pool, cell.n))
    llr = channel.received_llr(channel.encode(bits, k, polys),
                               cell.config["channel"]["ebn0_db"], gen)
    llr = llr.to(getattr(torch, cell.config["llr_dtype"]))
    host = torch.Generator().manual_seed(int(seed) % (1 << 64))
    order = torch.randperm(pool, generator=host).tolist()
    return Inputs(llr, bits, order)


class Kept:
    """The timed calls whose bits the check compares, each in a client
    slot that no later call overwrites: the first call (slot ``pool``),
    a uniform sample of ``SAMPLE_CALLS`` of the later calls drawn from the
    seed (reservoir sampling, slots ``pool + 1`` on) and the last call of
    every block that no sample slot took (slot = the block)."""

    def __init__(self, pool: int, seed: int):
        self.pool = pool
        self.rng = random.Random(seed)
        self.calls = 0
        self.outs = {}

    @property
    def slots(self) -> int:
        return self.pool + 1 + SAMPLE_CALLS

    def slot(self, p: int) -> int:
        """The slot of the next call, which decodes block ``p``."""
        if self.calls == 0:
            return self.pool
        t = self.calls - 1
        r = t if t < SAMPLE_CALLS else self.rng.randrange(t + 1)
        return self.pool + 1 + r if r < SAMPLE_CALLS else p

    def keep(self, slot: int, p: int, out) -> None:
        self.outs[slot] = (p, out)
        self.calls += 1

    def outputs(self) -> list:
        return [self.outs[s] for s in sorted(self.outs)]


def make_client(cell: Cell, inputs: Inputs, devices, slots: int,
                overrides=None):
    entry = load_module(cell.root, "clients", cell.traffic["entry"])
    return entry.Client(cell, list(inputs.llr), devices, slots, overrides)


def _loop(client, inputs: Inputs, seconds: float, kept: Kept,
          traced: bool = False):
    """Closed loop: issue a call, wait for its bits, issue the next, until
    ``seconds`` have passed, the bits of each call going to the slot that
    ``kept`` gives. ``traced`` marks each call's two halves with host
    spans. Returns (window seconds, latencies, host times)."""
    from torch.profiler import record_function
    pool = len(inputs.order)
    lat, host = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        p = inputs.order[i % pool]
        slot = kept.slot(p)
        t0 = time.perf_counter()
        with record_function("portbench.issue") if traced else _NOSPAN:
            handle = client.issue(p)
        t1 = time.perf_counter()
        with record_function("portbench.finish") if traced else _NOSPAN:
            out = client.finish(handle, slot)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        host.append(t1 - t0)
        kept.keep(slot, p, out)
        i += 1
        if t2 >= deadline:
            return t2 - t_start, lat, host


def check_outputs(cell: Cell, inputs: Inputs, outputs) -> dict:
    """Compare each (block, bits) output with the reference's decode of the
    same block's LLRs. Returns the counts."""
    ref_mod = load_module(cell.root, "reference", cell.config["reference"])
    ref_dev = inputs.llr.device
    cache, mismatches, compared, ref_err, out_err = {}, 0, 0, 0, 0
    for p, out in outputs:
        if p not in cache:
            cache[p] = ref_mod.reference_bits(cell.config, inputs.llr[p])
        ref = cache[p]
        out = out.to(ref_dev).reshape(-1)
        if out.shape != ref.shape:
            mismatches += ref.numel()
        else:
            mismatches += int((out != ref).sum())
            out_err += int((out != inputs.bits[p]).sum())
        ref_err += int((ref != inputs.bits[p]).sum())
        compared += ref.numel()
    return {"bit_mismatches": mismatches, "bits_compared": compared,
            "reference_ber": ref_err / max(compared, 1),
            "program_ber": out_err / max(compared, 1)}


def _breakdown(trace: timeline.Trace) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (the innermost host event over the
    middle of each gap), both in seconds summed over the devices."""
    ops = {}
    for e in trace.events:
        ops[e.name] = ops.get(e.name, 0.0) + e.us * 1e-6
    hs = np.array([h.start for h in trace.host])
    he = np.array([h.end for h in trace.host])
    idle = {}
    for d in trace.devices:
        for s, e in timeline.gaps([(x.start, x.end) for x in trace.of(d)],
                                  trace.lo, trace.hi):
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("host idle" if inside.size == 0 else
                    trace.host[inside[np.argmax(hs[inside])]].name)
            idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _device_info(devices, trace) -> dict:
    cuda = torch.device(devices[0]).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
            "count": len(devices),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in devices) if cuda else 0}
    if trace is not None:
        info["busy_s"] = (sum(trace.busy_us(i) for i in trace.devices)
                          / len(trace.devices) * 1e-6)
        info["window_s"] = trace.window_us * 1e-6
    return info


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             devices, t_process: float, log=print):
    """One run. Returns (result dict, checks dict): the result line's keys
    and, under ``checks``, each number compared with its limit. A call
    that raises ends the run with no result, so ``failed`` is 0."""
    cell = load_cell(root, workload)
    bench = load_benchmark(root)
    home = torch.device(devices[0])
    inputs = make_inputs(cell, seed, home)
    pool = len(inputs.order)
    kept = Kept(pool, seed)
    client = make_client(cell, inputs, devices, kept.slots)
    for p in range(pool):                      # warm-up: every shape once
        client.finish(client.issue(p), p)
    if home.type == "cuda":
        for d in devices:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_process

    window_s, lat, host = _loop(client, inputs, seconds, kept)
    run = Run(cell, setup_s, window_s, lat, host)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if home.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                _, traced_lat, _ = _loop(client, inputs, TRACE_SECONDS,
                                         kept, traced=True)
        idx = [torch.device(d).index or 0 for d in devices]
        run.trace = timeline.from_profile(
            prof, WINDOW_SPAN, sorted(set(idx)), len(traced_lat),
            torch.cuda.get_device_name(devices[0]) if home.type == "cuda"
            else "cpu")
        del prof

    device = _device_info(devices, run.trace)
    outputs = kept.outputs()
    del client
    gc.collect()
    if home.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts = check_outputs(cell, inputs, outputs)
    t_check = time.perf_counter() - t_check

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, kind):
        value = metric_reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"latency: median {np.median(lat) * 1e3:.4f} ms over {len(lat)} "
        f"calls in {window_s:.3f} s; compared {counts['bits_compared']} bits "
        f"of {len(outputs)} calls in {t_check:.2f} s; BER against the sent "
        f"bits: reference {counts['reference_ber']:.3e}, program "
        f"{counts['program_ber']:.3e}")
    checks = {"bit_mismatches": {"value": counts["bit_mismatches"],
                                 "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(lat), "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        result["breakdown"] = _breakdown(run.trace)
    result["checks"] = checks
    return result, checks
