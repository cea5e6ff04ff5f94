"""glue_device_ms (ms, device trace), layer "receiver call": device time
per call in kernels that are not the decode kernels: the clip, framing,
padding, contiguous copies and the stitch that surround the decode. Copies
(memcpy, memset) are not kernels and are not counted."""
from portbench.timeline import is_copy

#: Substrings of the decode kernels' names (``kernels/csrc``): the unified
#: kernel B1 and the split path's forward kernel B3 and traceback, in
#: every mapping (register, block, per-edge block, wide, cluster).
DECODE_KERNELS = ("viterbi_unified", "viterbi_fwd", "traceback_frames")


def is_decode(name: str) -> bool:
    return any(k in name for k in DECODE_KERNELS)


def read(run):
    tr = run.trace
    if tr is None or not any(is_decode(e.name) for e in tr.events):
        return None
    glue = sum(e.us for e in tr.events
               if not is_copy(e.name) and not is_decode(e.name))
    return glue / tr.calls * 1e-3
