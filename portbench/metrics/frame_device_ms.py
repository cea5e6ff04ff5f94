"""frame_device_ms (ms, device trace), layer "receiver call": device time
a call, summed over the cards, of every kernel, copy and fill launched
under the program's ``decode.frame`` (``frame_llr``: the edge padding and
the gather of the overlapping frames) and ``decode.pad`` spans
(``viterbi_decode_frames``: the move to the card, the float64 cast, the
block reframe, ``contiguous`` and the padding to the tile), over the
calls that pair (``portbench.spans``). None where the trace holds
neither span (the CPU, or a program without them)."""
from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, ("decode.frame", "decode.pad"))
