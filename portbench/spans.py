"""Put each device operation of a traced slice down to the program span
that launched it.

While a ``torch.profiler`` records, the port's decode path puts its spans
(``decode``, ``decode.*``, ``shard``, ``shard.*``; ``repro_torch.obs.
profiled``) into the profiler's trace, so the traced slice holds them as
host events beside the runtime calls that queue work on a card. A
``timeline.Trace`` keeps no correlation ids, so a launch is linked to its
device operation by order: a card's stream runs its work in the order it
was queued, and each runtime call that queues work (a kernel launch, a
copy, a fill) gives one device operation.

The slice is a closed loop, so a call's device work runs between its
``portbench.issue`` and the end of its ``portbench.finish``, each on the
host's clock. The profiler's device clock stands off the host's, and the
offset drifts (on an H100: from +5 us, the launch latency, to -6.4 ms
within one 1 s slice), so each call's operations are looked for on the
device clock at the call's host interval shifted by the offset, tracked
from call to call: after a call pairs, the offset is its first
operation's on the home card less that operation's launch (the home card
is idle when a call starts). The first call, or a call that does not
pair at the tracked offset, takes the shift nearest that offset (or 0),
within half a call, at which it pairs. A shift by whole calls puts the
same spans' operations under the same spans, so the metrics do not need
the calls told apart.

Within a call, a launch goes to the card of the ``shard.decode`` span it
runs under (the call's j-th ``shard.decode`` is the j-th of the trace's
devices) and every other launch to the home card, the first device; the
launches under ``shard.gather`` (the copies back, each run on the stream
of the card it leaves, after that card's decode) are left unpaired. A
card's launches pair one to one, in order, with the first device
operations the card ran in the call, and the rest must be as many as the
gather's launches. A call whose kinds (kernel, copy, fill) do not pair
so is left out, and is counted.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics

from portbench.timeline import DeviceEvent, HostEvent, Trace

__all__ = ["Launched", "Attribution", "attribute", "is_program_span",
           "launch_kind", "op_kind", "span_ms_per_call", "ISSUE", "FINISH"]

#: The harness's host spans around each call's two halves.
ISSUE, FINISH = "portbench.issue", "portbench.finish"
#: The runtime calls that queue device work, by the prefix of their name
#: (``cudaLaunchKernelExC`` launches a cluster), and the work's kind.
_LAUNCHES = (("cudaLaunchKernel", "kernel"), ("cudaMemcpy", "copy"),
             ("cudaMemset", "fill"))


def is_program_span(name: str) -> bool:
    """A span of the port's decode path."""
    return name in ("decode", "shard") or name.startswith(("decode.",
                                                           "shard."))


def launch_kind(name: str):
    """The kind of device operation a runtime call queues, or None for a
    call that queues none."""
    for prefix, kind in _LAUNCHES:
        if name.startswith(prefix):
            return kind
    return None


def op_kind(name: str) -> str:
    """The kind of a device operation, by the profiler's name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


@dataclasses.dataclass(frozen=True)
class Launched:
    """A device operation, its launch, the innermost program span over the
    launch (None outside every span) and the mesh card it ran for."""
    op: DeviceEvent
    launch: HostEvent
    span: str | None
    card: int


@dataclasses.dataclass
class Attribution:
    """The paired operations of the calls that paired (``calls``), the
    calls left out (``unpaired``), and for each paired call the wait of
    each card's first operation launched under its ``shard.decode`` span
    (us from its launch to its start on the host's clock, or None where
    the card has none)."""
    launched: list
    calls: int
    unpaired: int
    shard_waits: list


def _covering(spans, t: float) -> list:
    """The spans over time t, outermost first."""
    return sorted((s for s in spans if s.start <= t <= s.end),
                  key=lambda s: (s.start, -s.end))


def _shifts(starts, lo: float, hi: float, center: float,
            half: float) -> list:
    """The shifts of the device clock, within ``center`` +- ``half``, one
    for each set of operations that [lo, hi] shifted by them holds (an
    operation's start crosses an end of the window between two sets),
    nearest the center first."""
    cuts = {center - half, center + half}
    for end in (lo, hi):
        i = bisect.bisect_left(starts, end + center - half)
        j = bisect.bisect_right(starts, end + center + half)
        cuts.update(t - end for t in starts[i:j])
    cuts = sorted(cuts)
    return sorted(((a + b) / 2 for a, b in zip(cuts, cuts[1:])),
                  key=lambda x: abs(x - center))


def _pair_call(tr: Trace, host, ops_by_dev, lo: float, hi: float):
    """(Launched list, the call's shard.decode spans) of the call whose
    operations start in [lo, hi] on the device clock, or None when its
    launches and operations do not pair."""
    spans = [h for h in host if is_program_span(h.name)]
    decodes = sorted((s for s in spans if s.name == "shard.decode"),
                     key=lambda s: s.start)
    if len(decodes) > len(tr.devices):
        return None
    queued = {d: [] for d in tr.devices}
    gathered = 0
    for h in host:
        kind = launch_kind(h.name)
        if kind is None:
            continue
        over = _covering(spans, h.start)
        if any(s.name == "shard.gather" for s in over):
            gathered += 1
            continue
        card = next((decodes.index(s) for s in over
                     if s.name == "shard.decode"), 0)
        queued[tr.devices[card]].append(
            (h, kind, over[-1].name if over else None, card))
    launched, rest = [], 0
    for d in tr.devices:
        starts, ops = ops_by_dev[d]
        ops = ops[bisect.bisect_left(starts, lo):
                  bisect.bisect_right(starts, hi)]
        mine = queued[d]
        if len(ops) < len(mine) or any(
                op_kind(o.name) != q[1] for o, q in zip(ops, mine)):
            return None
        rest += len(ops) - len(mine)
        launched += [Launched(o, h, span, card)
                     for o, (h, _, span, card) in zip(ops, mine)]
    if rest != gathered or not any(x.op.device == tr.devices[0]
                                   for x in launched):
        return None
    return launched, decodes


def attribute(tr: Trace | None) -> Attribution | None:
    """The slice's device operations put down to program spans, or None
    where the trace holds no device operation or no program span (a run
    on the CPU, or a program without the spans)."""
    if tr is None or not tr.events or not any(
            is_program_span(h.name) for h in tr.host):
        return None
    host = sorted((h for h in tr.host if tr.lo <= h.start <= tr.hi),
                  key=lambda h: h.start)
    starts = [h.start for h in host]
    calls = [(i.start, f.end) for i, f in zip(
        (h for h in host if h.name == ISSUE),
        (h for h in host if h.name == FINISH))]
    out = Attribution([], 0, 0, [])
    if not calls:
        return out
    half = statistics.median(e - s for s, e in calls) / 2
    ops_by_dev = {}
    for d in tr.devices:
        ops = sorted(tr.of(d), key=lambda e: e.start)
        ops_by_dev[d] = ([o.start for o in ops], ops)
    every = sorted(e.start for e in tr.events)
    offset = None
    for lo, hi in calls:
        call = host[bisect.bisect_left(starts, lo):
                    bisect.bisect_right(starts, hi)]
        call = [h for h in call if h.end <= hi]
        paired = None if offset is None else _pair_call(
            tr, call, ops_by_dev, lo + offset, hi + offset)
        if paired is None:
            for shift in _shifts(every, lo, hi,
                                 0.0 if offset is None else offset, half):
                paired = _pair_call(tr, call, ops_by_dev, lo + shift,
                                    hi + shift)
                if paired is not None:
                    break
        if paired is None:
            out.unpaired += 1
            continue
        launched, decodes = paired
        first = min((x for x in launched if x.op.device == tr.devices[0]),
                    key=lambda x: x.launch.start)
        offset = first.op.start - first.launch.start
        waits = []
        for card, span in enumerate(decodes):
            mine = [x for x in launched if x.card == card and
                    span.start <= x.launch.start <= span.end]
            waits.append(mine[0].op.start - offset - mine[0].launch.start
                         if mine else None)
        out.launched += launched
        out.shard_waits.append(waits)
        out.calls += 1
    return out


def span_ms_per_call(run, names) -> float | None:
    """Device milliseconds a call of the operations launched under the
    spans ``names`` (innermost), over the paired calls; None where nothing
    was paired or no such span is in the trace."""
    att = attribute(run.trace)
    if att is None or att.calls == 0 or not any(
            h.name in names for h in run.trace.host):
        return None
    us = sum(x.op.us for x in att.launched if x.span in names)
    return us / att.calls * 1e-3
