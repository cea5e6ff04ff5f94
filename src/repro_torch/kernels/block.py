"""Intra-frame block-parallel decode: policy + geometry for the kernels
(port of ``repro.kernels.block``, pure Python).

All other parallelism in this package is *across* frames — each frame's
L-stage ACS scan is still a sequential loop, so a long frame
bounds kernel throughput and serve window latency no matter how many
frames a tile holds. The block-based Gb/s decoder (arXiv 1608.00066)
removes that bound: split one frame's f kept stages into ``block_frames``
independent blocks of ``f/B`` stages, give every block an ``overlap``-
stage *training* region on the left (ACS warm-up from a uniform metric,
exactly like the frame's own v1) and *truncation* region on the right
(traceback convergence, like v2), decode the blocks in parallel, and drop
the overlap regions at merge. Blocks are just shorter frames laid out on
the existing frame axis, so the unchanged unified/split kernels decode
them — one long frame fills a tile the way many short frames do today,
the per-tile scan shrinks from ``v1+f+v2`` to ``f/B + 2*overlap`` stages,
and the bit-packed survivor machinery works as-is in both layouts.

Accuracy is the standard truncated-traceback trade-off: with ``overlap``
at least ~5 constraint lengths the survivor paths have converged and the
BER penalty is below the 1e-3 gate. Two exactness regimes anchor the
tests:

* ``overlap <= min(v1, v2)``: every block window lies inside its frame's
  real data, so the blocked decode is bit-identical to re-framing the
  stream with ``spec.blocked(B, overlap)`` (fine-framing equivalence).
* ``overlap >= full_overlap(spec, B)``: every block window covers the
  whole frame, warm-up and truncation degenerate away, and the decode is
  bit-identical to the unblocked frame decode (the degenerate gate).

The geometry primitives (``FrameSpec.blocked``, ``reframe_blocks``,
``merge_blocks``) live in core/framed.py next to ``frame_llr``; this
module adds the policy: default truncation depth, the auto block count,
and the ``resolve_block`` entry ``core.pipeline`` uses.
"""
from __future__ import annotations

from ..core.framed import (FrameSpec, merge_blocks,  # noqa: F401 (re-export)
                           reframe_blocks)
from ..core.trellis import Trellis

__all__ = ["BLOCK_LEN_THRESHOLD", "TRUNCATION_DEPTH_MULT", "default_overlap",
           "full_overlap", "choose_block_frames", "resolve_block",
           "reframe_blocks", "merge_blocks"]

#: Kept stages per frame below which the ``"auto"`` policy leaves blocking
#: off: short frames already fill tiles across the frame axis, and the
#: 2*overlap training/truncation tax (~70 stages at K=7) would dominate.
BLOCK_LEN_THRESHOLD = 1024

#: Default truncation depth in constraint lengths. ~5*K is the classic
#: rule of thumb for truncated Viterbi traceback: survivor paths merge
#: with overwhelming probability within that window, putting the BER
#: penalty well under the 1e-3 gate.
TRUNCATION_DEPTH_MULT = 5


def default_overlap(trellis: Trellis, spec: FrameSpec | None = None) -> int:
    """The ~5*K truncation-depth default, widened to cover a parallel-
    traceback spec's v2s (the derived block spec needs v2s <= overlap)."""
    ov = TRUNCATION_DEPTH_MULT * trellis.k
    if spec is not None and spec.parallel_tb:
        ov = max(ov, spec.v2s)
    return ov


def full_overlap(spec: FrameSpec, block_frames: int) -> int:
    """Smallest overlap at which EVERY block's window covers the whole
    frame — the degenerate regime where blocking is bit-identical to the
    unblocked decode (block b spans ``[v1 + b*fb - ov, v1+(b+1)*fb + ov)``;
    the last block needs ``ov >= v1 + (B-1)*fb`` to reach stage 0, the
    first needs ``ov >= v2 + (B-1)*fb`` to reach the frame end)."""
    B = int(block_frames)
    if spec.f % B != 0:
        raise ValueError(f"f={spec.f} is not a multiple of "
                         f"block_frames={B}")
    return (B - 1) * (spec.f // B) + max(spec.v1, spec.v2)


def choose_block_frames(spec: FrameSpec, overlap: int) -> int:
    """Largest block count that divides f, keeps the block body at least
    twice the overlap (so the training/truncation tax stays under ~50% of
    the scan), and preserves a parallel-traceback geometry (f0 | block).
    Returns 1 when no usable split exists."""
    ov = int(overlap)
    for B in range(spec.f, 1, -1):
        if spec.f % B != 0:
            continue
        fb = spec.f // B
        if fb < max(1, 2 * ov):
            continue
        if spec.parallel_tb and fb % spec.f0 != 0:
            continue
        return B
    return 1


def resolve_block(trellis: Trellis, spec: FrameSpec,
                  block_frames: int | str = 1,
                  overlap: int | None = None) -> tuple[int, int]:
    """Resolve the user-facing (block_frames, overlap) knobs to concrete
    ints: ``(1, 0)`` means blocking is off. ``block_frames`` may be an
    explicit count (validated against the spec), or ``"auto"`` — engage
    only past BLOCK_LEN_THRESHOLD kept stages, with ``choose_block_frames``
    picking the split. ``overlap=None`` takes the ~5*K default."""
    if block_frames in (None, 0, 1):
        return 1, 0
    ov = default_overlap(trellis, spec) if overlap is None else int(overlap)
    if block_frames == "auto":
        if spec.f < BLOCK_LEN_THRESHOLD:
            return 1, 0
        B = choose_block_frames(spec, ov)
        if B == 1:
            return 1, 0
    else:
        B = int(block_frames)
    spec.blocked(B, ov)                     # validate the derived geometry
    return B, ov
