"""depuncture_device_ms (ms, device trace), layer "receiver call": device
time a call of every kernel, copy and fill launched under the program's
``decode.depuncture`` span (``make_decoder``'s depuncture of a punctured
stream into the mother code's (n, beta) LLRs), over the calls whose
launches pair with their device operations (``portbench.spans``). None
where the trace holds no such span: on the CPU, at rate 1/2, or in a
program without it."""
from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, ("decode.depuncture",))
