"""Reduce a profiler trace to what the per-layer metrics read.

The traced slice runs under ``torch.profiler.profile`` with the CPU and
CUDA activities. Every device-side event (kernel, memcpy, memset) becomes
a ``DeviceEvent``; the host spans that the harness records around its
calls (``torch.profiler.record_function``) and the operators under them
become ``HostEvent``s. Times are microseconds on the profiler's clock.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DeviceEvent", "HostEvent", "Trace", "from_profile", "union_us",
           "gaps", "is_copy", "SPAN_PREFIX"]

#: The prefix of the harness's own host spans.
SPAN_PREFIX = "portbench."


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    device: int
    name: str
    start: float
    end: float

    @property
    def us(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class HostEvent:
    name: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    """The traced slice: device events inside [lo, hi], the host events,
    the devices in use, the number of calls the slice completed and the
    card's name."""
    events: list
    host: list
    lo: float
    hi: float
    devices: list
    calls: int
    device_kind: str

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def of(self, device: int) -> list:
        return [e for e in self.events if e.device == device]

    def busy_us(self, device: int) -> float:
        return union_us([(e.start, e.end) for e in self.of(device)],
                        self.lo, self.hi)


def is_copy(name: str) -> bool:
    """A device-side copy or fill (the profiler names them Memcpy ... and
    Memset ...), not a kernel."""
    return name.startswith("Memcpy") or name.startswith("Memset")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


def from_profile(prof, window_name: str, devices: list, calls: int,
                 device_kind: str) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``: the window
    is the host span named ``window_name``."""
    from torch.autograd import DeviceType
    dev_events, host = [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # a host span's copy on the device timeline is no device work
            if getattr(ev, "is_user_annotation", False) or \
                    ev.name.startswith(SPAN_PREFIX):
                continue
            dev_events.append(DeviceEvent(int(ev.device_index), ev.name,
                                          start, end))
        elif ev.device_type == DeviceType.CPU:
            host.append(HostEvent(ev.name, start, end))
    spans = [h for h in host if h.name == window_name]
    if not spans:
        raise RuntimeError(f"the trace holds no {window_name!r} span")
    lo, hi = spans[0].start, spans[0].end
    inside = [e for e in dev_events if e.end > lo and e.start < hi]
    return Trace(inside, host, lo, hi, list(devices), calls, device_kind)
