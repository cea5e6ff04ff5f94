"""sanitize_device_ms (ms, device trace), layer "receiver call": device
time a call of every kernel, copy and fill launched under the program's
``decode.sanitize`` span (``make_decoder``'s clip of the LLRs), over the
calls whose launches pair with their device operations
(``portbench.spans``). None where the trace holds no such span: on the
CPU, in the mesh client (it has no clip), or in a program without it."""
from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, ("decode.sanitize",))
