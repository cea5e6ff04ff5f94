"""h2d_ms_per_call (ms, device trace), layer "receiver call, copy in":
device time per call of the host-to-device copies (make_decoder's
``torch.as_tensor(stream).to(dev)`` of LLRs that wait in host memory)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    copies = [e.us for e in tr.events if e.name.startswith("Memcpy HtoD")]
    return sum(copies) / tr.calls * 1e-3 if copies else None
