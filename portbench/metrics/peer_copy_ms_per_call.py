"""peer_copy_ms_per_call (ms, device trace), layer "distribution": device
time per call of the copies between cards: the shards out of the home
card and their bits back (the profiler names them Memcpy PtoP)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    copies = [e.us for e in tr.events if e.name.startswith("Memcpy PtoP")]
    return sum(copies) / tr.calls * 1e-3 if copies else None
