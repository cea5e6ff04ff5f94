"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

Written on top of the reference algorithms of ``repro_torch.core``, so
kernel == plain version == ref == Alg. 1+2.
"""
from __future__ import annotations

import torch

from ..core.decoder import viterbi_forward
from ..core.framed import FrameSpec, decode_frame
from ..core.trellis import Trellis

__all__ = ["unified_decode_frames_ref", "forward_frames_ref"]


def unified_decode_frames_ref(frames: torch.Tensor, trellis: Trellis,
                              spec: FrameSpec) -> torch.Tensor:
    """(F, L, beta) -> (F, f) int32 bits; oracle for viterbi_unified."""
    return decode_frame(frames, trellis, spec)


def forward_frames_ref(frames: torch.Tensor, trellis: Trellis):
    """(F, L, beta) -> (sel (F, L, S) int8, amax (F, L) int32); oracle for
    viterbi_fwd."""
    sel, _, amax = viterbi_forward(frames, trellis)
    return sel.to(torch.int8), amax.to(torch.int32)
