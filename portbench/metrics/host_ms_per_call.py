"""host_ms_per_call (ms, host clock), layer "dispatch": the host's time
from issuing a call to the entry's return, before any wait on the card,
summed over the window's calls and divided by their number. It holds
make_decoder's Python, kernels.ops.viterbi_decode_frames and
kernels.autotune.plan_tiles, and in a host cell the copy in."""


def read(run):
    return sum(run.host_s) / len(run.host_s) * 1e3
