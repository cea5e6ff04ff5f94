"""plan_ms_per_call (ms, host clock), layer "dispatch": the host's time a
call in the program's ``decode.plan`` spans (``kernels.autotune.
plan_tiles``, which ``viterbi_decode_frames`` runs for
``frames_per_tile="auto"``; one a card in the mesh), over the traced
slice's calls, on the profiler's host clock. Read in a run on a card
alone (a trace with device events): on the CPU the planner plans for a
card it does not drive. None where the trace holds no such span."""


def read(run):
    tr = run.trace
    if tr is None or not tr.events:
        return None
    plans = [h.end - h.start for h in tr.host
             if h.name == "decode.plan" and tr.lo <= h.start <= tr.hi]
    return sum(plans) / tr.calls * 1e-3 if plans else None
