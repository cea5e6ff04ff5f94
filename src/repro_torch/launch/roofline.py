"""Roofline of the decode on H100s: port of ``repro.launch.roofline``.

    compute term    = operations per card / float32 non-tensor op/s
    memory term     = HBM bytes per card / HBM bytes/s
    collective term = bytes the home card moves over NVLink / NVLink B/s

The JAX package reads its operations and bytes from compiled XLA HLO
(``hlo_cost.py``, ``collective_bytes``). The port has no HLO: its decode
is three hand-written kernels, so ``kernel_work`` counts each kernel's
work from its shapes, the way the roofline counts it: every input byte read
once, every output byte written once, and the operations these inputs
need.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.framed import FrameSpec
from ..core.trellis import Trellis
from ..kernels.packing import packed_width
from .mesh import HW

__all__ = ["ACS_OPS", "TB_OPS", "KERNELS", "Roofline", "kernel_work",
           "kernel_bound", "decode_roofline", "count_params"]

#: ACS operations per state and stage: two candidate adds, compare, select,
#: the max reduction's compare and the normalising subtract.
ACS_OPS = 6
#: Integer operations per traceback step: word index, load offset, shift,
#: mask, the butterfly's shift-and-or, the bit out. Counted against the f32
#: non-tensor rate, the table's nearest; they never bind.
TB_OPS = 6
#: The decode kernels by backend.
KERNELS = {"kernel": ("viterbi_unified",),
           "kernel_split": ("viterbi_fwd", "traceback_frames")}


def _traceback_geometry(spec: FrameSpec):
    """(subframes per frame, steps per cursor): serial is one subframe."""
    if spec.parallel_tb:
        return spec.f // spec.f0, spec.f0 + spec.v2s
    return 1, spec.f + spec.v2


def kernel_work(kernel: str, trellis: Trellis, spec: FrameSpec, F: int, *,
                pack_survivors: bool = True, llr_bytes: int = 4):
    """(bytes, operations) of one launch of ``kernel`` over F frames.

    * ``viterbi_unified`` (B1): reads the LLR frames, writes the (F, f)
      int32 bits; ACS_OPS per state and stage.
    * ``viterbi_fwd`` (B3): reads the frames, writes the survivors (F, L)
      rows of packed int32 words or one byte per state, and the (F, L)
      int32 argmax; ACS_OPS per state and stage.
    * ``traceback_frames``: each of the F x nsub cursors reads one
      survivor word (or byte) per step and its int32 start, and the bits
      are written once; TB_OPS per step.
    """
    L, S, f = spec.frame_len, trellis.num_states, spec.f
    frames = F * L * trellis.beta * llr_bytes
    bits = F * f * 4
    row = 4 * packed_width(S) if pack_survivors else S
    word = 4 if pack_survivors else 1
    if kernel == "viterbi_unified":
        return frames + bits, ACS_OPS * F * L * S
    if kernel == "viterbi_fwd":
        return frames + F * L * row + F * L * 4, ACS_OPS * F * L * S
    if kernel == "traceback_frames":
        nsub, steps = _traceback_geometry(spec)
        cursors = F * nsub
        return (cursors * steps * word + cursors * 4 + bits,
                TB_OPS * cursors * steps)
    raise ValueError(f"unknown kernel {kernel!r}; one of "
                     f"viterbi_unified, viterbi_fwd, traceback_frames")


def kernel_bound(nbytes: float, nops: float):
    """(bound_ms, bound_by) on one card: the larger of the bytes over the
    HBM rate and the operations over the float32 non-tensor rate."""
    bytes_ms = nbytes / HW.HBM_BW * 1e3
    ops_ms = nops / HW.PEAK_F32_OPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one decode across ``chips`` cards. The operations
    keep the JAX package's field name ``flops_per_chip``; they are the
    ACS's float32 operations (and the traceback's integer ones), which run
    on no tensor core, so ``t_compute`` divides by the float32 rate
    outside the tensor cores."""
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float      # the home card, busier direction
    coll_breakdown: dict
    peak_memory_per_chip: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / HW.PEAK_F32_OPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / HW.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> dict:
        return {
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_chip": self.peak_memory_per_chip,
        }


def decode_roofline(trellis: Trellis, spec: FrameSpec, nbits: int,
                    chips: int, *, backend: str = "kernel",
                    pack_survivors: bool = True,
                    frames_multiple: int = 1) -> Roofline:
    """The frame-sharded decode of ``nbits`` bits on ``chips`` cards.

    The frames are padded to a multiple of ``chips x frames_multiple``
    (the kernel's tile) and split evenly. Per card: the work of the
    backend's kernels over its shard. Across cards: the home card scatters
    (chips-1)/chips of the frames and gathers as much of the bits; the two
    directions overlap, so the larger sets the collective term. The home
    card's HBM holds the (n, beta) LLR stream, all frames and all bits,
    plus the split path's survivors and argmax of its own shard."""
    if backend not in KERNELS:
        raise ValueError(f"backend must be one of {sorted(KERNELS)}, got "
                         f"{backend!r}")
    step = chips * frames_multiple
    F = -(-spec.num_frames(nbits) // step) * step
    per = F // chips
    nbytes = nops = 0
    for kernel in KERNELS[backend]:
        b, o = kernel_work(kernel, trellis, spec, per,
                           pack_survivors=pack_survivors)
        nbytes, nops = nbytes + b, nops + o
    beta, L = trellis.beta, spec.frame_len
    frame_bytes = per * L * beta * 4
    bit_bytes = per * spec.f * 4
    coll = {"scatter_frames": (chips - 1) * frame_bytes,
            "gather_bits": (chips - 1) * bit_bytes}
    scratch = 0
    if backend == "kernel_split":
        row = 4 * packed_width(trellis.num_states) if pack_survivors \
            else trellis.num_states
        scratch = per * L * (row + 4)
    home = nbits * beta * 4 + chips * (frame_bytes + bit_bytes) + scratch
    return Roofline(chips=chips, flops_per_chip=float(nops),
                    bytes_per_chip=float(nbytes),
                    coll_bytes_per_chip=float(max(coll.values())),
                    coll_breakdown=coll, peak_memory_per_chip=float(home))


def count_params(params) -> int:
    """Elements of every parameter of a ``Params`` tree (or a dict of
    tensors); meta tensors count alike."""
    items = (params.parameters() if hasattr(params, "parameters")
             else params.values())
    return sum(int(p.numel()) for p in items)
