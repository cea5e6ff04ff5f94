"""The split path's traceback: survivor stream + argmax in device memory ->
decoded bits (the second half of the paper's Table I row b).

In the JAX package this step is an XLA scan outside Pallas
(``repro.core.traceback.*_frames``); here it is a CUDA kernel
(``csrc/traceback_frames.cu``) so that the split path's time is the
survivor round trip through device memory and not a Python loop of small
launches. Its plain version is ``core.traceback.*_frames``.

* ``traceback_frames`` dispatches by the tensor's device: a CUDA tensor to
  the kernel, a CPU tensor to the plain version, no fallback;
* ``traceback_frames_cuda`` checks, allocates the (F, f) bits, launches on
  the current stream, raises on any failure and counts ``.launches``;
* ``traceback_frames_plain`` picks the plain serial or parallel chase.

Geometry as the unified kernel takes it: ``nsub = f // f0`` cursors per
frame, cursor q starting at stage ``v1 + (q+1)*f0 - 1 + v2s``; the serial
traceback is the one cursor ``f0 = f, v2s = L - v1 - f`` starting from the
last stage's argmax.

The kernel chases in one of two modes (``chase_plan``), by a rule on the
shape: **staged** (a group of frames' survivor window is copied into
shared memory and chased there) where a stage's row is at most
``STAGE_ROW_BYTES`` = 128 bytes (packed k <= 11, unpacked k <= 8) and the
smallest group fits ``STAGE_BYTES``; **direct** (the chase reads device
memory) otherwise. A chase step reads one 32-byte sector of its row at a
random place; copying a row of up to four sectors streams, where the
direct chase's reads are random; wider rows would be copied for one word
in dozens. The smallest group is one frame in the lane layout and
``SUBLANE_MIN_GROUP`` = 8 frames in the sublane one, whose rows hold a
group's frames side by side: fewer than 8 int32 words of a row are less
than a sector. ``chase=`` pins a mode, for timing the two against each
other; neither stands in for the other when it fails.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.traceback import parallel_traceback_frames, serial_traceback_frames
from ..core.trellis import Trellis
from .autotune import H100_LIMITS, H100_SMS, device_limits
from .build import build
from .packing import Layout, packed_width

__all__ = ["traceback_frames", "traceback_frames_cuda",
           "traceback_frames_plain", "kernel_library", "chase_plan",
           "ChasePlan", "STAGE_ROW_BYTES", "STAGE_BYTES", "MAX_GROUP",
           "SUBLANE_MIN_GROUP", "H100_SMS"]

SOURCE = "traceback_frames.cu"
#: Widest stage row (bytes) that the staged mode copies into shared memory.
STAGE_ROW_BYTES = 128
#: Shared memory a staged block may take, so that several blocks share an
#: SM and one block's copy overlaps the others' chases.
STAGE_BYTES = 40 * 1024
#: Most frames one block takes.
MAX_GROUP = 32
#: Fewest frames a staged sublane block takes (a row's int32 words of 8
#: frames fill one 32-byte sector).
SUBLANE_MIN_GROUP = 8


@dataclasses.dataclass(frozen=True)
class ChasePlan:
    """How the traceback kernel runs one call: ``staged`` (or direct),
    ``frames`` per block, ``threads`` per block and ``smem_bytes`` of
    dynamic shared memory (the kernel's ``tb_layout``)."""
    staged: bool
    frames: int
    threads: int
    smem_bytes: int


def _smem_bytes(k, f, v2s, L, packed, sublane, G, staged) -> int:
    """``csrc/traceback_frames.cu::tb_layout``, term for term."""
    S = 1 << (k - 1)
    W = packed_width(S)
    row = 4 * W if packed else S
    bits = -(-G * f // 32) * 4                  # packed bits, 32-bit words
    slab = 0
    if staged:
        win = f + v2s
        if sublane:
            slab = win * row * G
        else:
            slab = ((G - 1) * L + win) * row + 16
    return 16 + -(-bits // 16) * 16 + slab


def chase_plan(trellis: Trellis, *, L: int, f: int, f0: int, v2s: int,
               F: int, packed: bool, layout: str = "lane",
               chase: str = "auto",
               smem_limit: int = H100_LIMITS.smem_per_block,
               sms: int = H100_SMS,
               blocks_per_sm: int = H100_LIMITS.blocks_per_sm) -> ChasePlan:
    """The traceback kernel's mode and block for one call.

    ``chase="auto"`` takes the staged mode iff a stage row (``4 *
    ceil(S/32)`` bytes packed, ``S`` unpacked) is at most
    ``STAGE_ROW_BYTES`` and a block of the smallest group (one frame lane,
    ``SUBLANE_MIN_GROUP`` sublane) fits ``STAGE_BYTES``; else direct. A
    staged block takes the most frames, a power of two up to
    ``MAX_GROUP``, that fit ``STAGE_BYTES``. A direct block takes the
    fewest frames that still put every block on the card at once
    (``blocks_per_sm`` on each of ``sms`` SMs): its chase waits on
    device memory at every step, so it wants all cursors in flight, and
    small blocks spread them evenly and write their bits out each on its
    own. ``chase="staged"`` raises where the block does not fit
    ``smem_limit`` (the card's per-block shared memory)."""
    if chase not in ("auto", "staged", "direct"):
        raise ValueError(f"chase must be 'auto', 'staged' or 'direct', got "
                         f"{chase!r}")
    sub = Layout(layout) is Layout.SUBLANE
    k, S = trellis.k, trellis.num_states
    row = 4 * packed_width(S) if packed else S
    nsub = f // f0

    def smem(G, staged):
        return _smem_bytes(k, f, v2s, L, packed, sub, G, staged)

    least = SUBLANE_MIN_GROUP if sub else 1
    if chase == "auto":
        staged = row <= STAGE_ROW_BYTES and smem(least, True) <= STAGE_BYTES
    else:
        staged = chase == "staged"
    cover = 1 << max(0, int(F) - 1).bit_length()     # G need not exceed F
    if staged:
        G = 1
        while 2 * G <= min(MAX_GROUP, cover) and smem(2 * G, True) <= \
                STAGE_BYTES:
            G *= 2
    else:
        G = max(1, min(MAX_GROUP, -(-int(F) // (sms * blocks_per_sm))))
    if smem(G, staged) > smem_limit:
        raise ValueError(f"a {'staged' if staged else 'direct'} traceback "
                         f"block of {G} frames needs {smem(G, staged)} bytes "
                         f"of shared memory, over the {smem_limit} a block "
                         f"can have")
    threads = min(1024, max(32, -(-G * nsub // 32) * 32))
    return ChasePlan(staged, G, threads, smem(G, staged))


def kernel_library():
    """Build (at first use) and load the kernel; returns build.Built."""
    built = build(SOURCE)
    lib = built.lib
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.traceback_frames_launch.argtypes = (
            [vp] * 3 + [ctypes.c_longlong] + [i] * 13 + [vp])
        lib.traceback_frames_launch.restype = i
        lib.traceback_frames_smem_bytes.argtypes = [i] * 8
        lib.traceback_frames_smem_bytes.restype = ctypes.c_longlong
        lib._argtypes_set = True
    return built


def _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed, layout):
    """Validate; returns (layout, F, L)."""
    lay = Layout(layout)
    if amax.ndim != 2:
        raise ValueError(f"amax must be (F, L), got {tuple(amax.shape)}")
    F, L = amax.shape
    S = trellis.num_states
    row = packed_width(S) if packed else S
    want = ((L * row, F) if packed else (L, S, F)) if lay is Layout.SUBLANE \
        else (F, L, row)
    if tuple(sel.shape) != want:
        raise ValueError(f"sel must be {want} for layout={lay.value} "
                         f"packed={packed}, got {tuple(sel.shape)}")
    if f0 < 1 or f % f0 or v2s < 0 or v1 < 0 or v1 + f + v2s > L:
        raise ValueError(f"need f % f0 == 0 and v1 + f + v2s <= L, got "
                         f"v1={v1} f={f} f0={f0} v2s={v2s} L={L}")
    if start not in ("boundary", "fixed"):
        raise ValueError(f"start must be 'boundary' or 'fixed', got {start!r}")
    return lay, F, L


def traceback_frames(sel: torch.Tensor, amax: torch.Tensor, *,
                     trellis: Trellis, v1: int, f: int, f0: int, v2s: int,
                     start: str = "boundary", packed: bool = False,
                     layout: str = "lane") -> torch.Tensor:
    """(sel, amax) of ``forward_frames`` -> (F, f) int32 bits."""
    kw = dict(trellis=trellis, v1=v1, f=f, f0=f0, v2s=v2s, start=start,
              packed=packed, layout=layout)
    if sel.is_cuda:
        return traceback_frames_cuda(sel, amax, **kw)
    if sel.device.type != "cpu":
        raise ValueError(f"no traceback kernel for device {sel.device}")
    return traceback_frames_plain(sel, amax, **kw)


def traceback_frames_cuda(sel: torch.Tensor, amax: torch.Tensor, *,
                          trellis: Trellis, v1: int, f: int, f0: int,
                          v2s: int, start: str = "boundary",
                          packed: bool = False, layout: str = "lane",
                          chase: str = "auto") -> torch.Tensor:
    """Launch the CUDA kernel. ``sel`` may be a frame slice of a sublane
    stream (``sel[..., :F]``): its rows are read at their stride.
    ``chase`` goes to ``chase_plan`` (the default is its shape rule)."""
    lay, F, L = _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed,
                          layout)
    if not (sel.is_cuda and amax.device == sel.device):
        raise ValueError(f"sel and amax must lie on one CUDA device, got "
                         f"{sel.device} and {amax.device}")
    if sel.dtype != (torch.int32 if packed else torch.int8) \
            or amax.dtype != torch.int32:
        raise ValueError(f"sel must be {'int32' if packed else 'int8'} and "
                         f"amax int32, got {sel.dtype} and {amax.dtype}")
    if not amax.is_contiguous():
        raise ValueError("amax must be contiguous")
    ld = 0
    if lay is Layout.SUBLANE:
        ld = sel.stride(-2)
        if sel.stride(-1) != 1 or (sel.ndim == 3
                                   and sel.stride(0) != sel.shape[1] * ld):
            raise ValueError("a sublane sel must have unit frame stride and "
                             "evenly strided rows")
    elif not sel.is_contiguous():
        raise ValueError("a lane sel must be contiguous")
    dev = sel.device
    out = torch.empty((F, f), dtype=torch.int32, device=dev)
    if F == 0:
        return out
    limits = device_limits(dev)
    plan = chase_plan(
        trellis, L=L, f=f, f0=f0, v2s=v2s, F=F, packed=packed,
        layout=lay.value, chase=chase,
        smem_limit=limits.smem_per_block,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        blocks_per_sm=limits.blocks_per_sm)
    lib = kernel_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.traceback_frames_launch(
            sel.data_ptr(), amax.data_ptr(), out.data_ptr(), ld, F, L,
            trellis.k, v1, f, f0, v2s, int(packed),
            int(lay is Layout.SUBLANE), int(start == "fixed"), plan.frames,
            int(plan.staged), plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"traceback_frames launch failed: CUDA error "
                           f"{err}")
    traceback_frames_cuda.launches += 1
    return out


traceback_frames_cuda.launches = 0


def traceback_frames_plain(sel: torch.Tensor, amax: torch.Tensor, *,
                           trellis: Trellis, v1: int, f: int, f0: int,
                           v2s: int, start: str = "boundary",
                           packed: bool = False,
                           layout: str = "lane") -> torch.Tensor:
    """``core.traceback``'s serial chase for the one cursor that starts at
    the last stage from its argmax, the parallel chase otherwise."""
    lay, _, L = _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed,
                          layout)
    if f0 == f and start == "boundary" and v1 + f + v2s == L:
        return serial_traceback_frames(sel, amax, trellis, v1, f,
                                       packed=packed, layout=lay)
    return parallel_traceback_frames(sel, amax, trellis, v1, f, f0, v2s,
                                     start, packed=packed, layout=lay)
