"""Plain torch oracle for the unified kernel (port of ``repro.kernels.ref``).

Written on top of the reference algorithms of ``repro_torch.core``, so
kernel == plain version == ref == Alg. 1+2.
"""
from __future__ import annotations

import torch

from ..core.framed import FrameSpec, decode_frame
from ..core.trellis import Trellis

__all__ = ["unified_decode_frames_ref"]


def unified_decode_frames_ref(frames: torch.Tensor, trellis: Trellis,
                              spec: FrameSpec) -> torch.Tensor:
    """(F, L, beta) -> (F, f) int32 bits; oracle for viterbi_unified."""
    return decode_frame(frames, trellis, spec)
