"""Framed (tiled) parallel Viterbi decoding (paper §III Fig. 2, §IV); port of
``repro.core.framed``.

The n-stage stream is cut into F = ceil(n/f) frames. Frame m decodes output
stages [m*f, (m+1)*f) but processes stages [m*f - v1, m*f + f + v2): the
left overlap v1 warms up the path metrics, the right overlap v2 lets the
survivor path converge. Frames are independent: a batch dimension here, a
thread block's frames in the CUDA kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import framing
from ..obs.profiled import span_tracer
from .decoder import viterbi_forward
from .traceback import parallel_traceback, serial_traceback
from .trellis import Trellis

__all__ = ["FrameSpec", "frame_received", "frame_llr", "decode_frame", "framed_decode",
           "reframe_blocks", "merge_blocks"]


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Tiling parameters (paper notation)."""
    f: int = 256          # kept stages per frame
    v1: int = 20          # left overlap (warm-up)
    v2: int = 20          # right overlap (traceback convergence)
    f0: int = 0           # subframe length for parallel traceback (0 = serial)
    v2s: int = 0          # subframe overlap (parallel traceback)
    start: str = "boundary"   # parallel-traceback start-state strategy

    @property
    def frame_len(self) -> int:       # L = v1 + f + v2
        return self.v1 + self.f + self.v2

    @property
    def parallel_tb(self) -> bool:
        return self.f0 > 0

    def num_frames(self, n: int) -> int:
        return -(-n // self.f)

    def validate(self):
        if self.parallel_tb:
            if self.f % self.f0 != 0:
                raise ValueError(
                    f"f={self.f} is not a multiple of f0={self.f0}; the "
                    f"parallel traceback needs f % f0 == 0 (paper §IV-E)")
            if self.v2s > self.v2:
                raise ValueError(
                    f"v2s={self.v2s} exceeds v2={self.v2}; the subframe "
                    f"convergence overlap must fit in the frame overlap")

    def blocked(self, block_frames: int, overlap: int) -> "FrameSpec":
        """The per-block FrameSpec of the intra-frame block-parallel decode:
        each frame's f kept stages split into ``block_frames`` blocks of
        ``f / block_frames`` stages, each with an ``overlap``-stage training
        region on the left and truncation region on the right (arXiv
        1608.00066). A parallel-traceback geometry carries over (f0 must
        divide the block, v2s must fit the block overlap)."""
        B, ov = int(block_frames), int(overlap)
        if B < 1:
            raise ValueError(f"block_frames must be >= 1, got {block_frames}")
        if ov < 0:
            raise ValueError(f"overlap must be >= 0, got {overlap}")
        if self.f % B != 0:
            raise ValueError(
                f"f={self.f} is not a multiple of block_frames={B}; "
                f"intra-frame blocking needs f % block_frames == 0")
        fb = self.f // B
        if self.parallel_tb:
            if fb % self.f0 != 0:
                raise ValueError(
                    f"block length f/block_frames={fb} is not a multiple "
                    f"of f0={self.f0}; shrink f0 or use fewer blocks")
            if self.v2s > ov:
                raise ValueError(
                    f"v2s={self.v2s} exceeds the block overlap={ov}; the "
                    f"subframe convergence region must fit in it")
        sub = FrameSpec(f=fb, v1=ov, v2=ov,
                        f0=self.f0 if self.parallel_tb else 0,
                        v2s=self.v2s if self.parallel_tb else 0,
                        start=self.start)
        sub.validate()
        return sub


def frame_received(stream: torch.Tensor, n: int, spec: FrameSpec,
                   rate: str = "1/2", clip: float | None = None,
                   rows: int | None = None, *,
                   plain: bool = False) -> torch.Tensor:
    """The receiver call's front end: the received stream of n stages ->
    (rows, L, beta) overlapping frames, zero-padded at the stream's edges
    (zero LLR is metric-neutral, like a depunctured erasure), clipped
    first when ``clip`` is given (``core.sanitize``'s rule). ``stream`` is
    (n, beta) LLRs or their flat (n * beta,) view at rate 1/2, else the
    (m,) punctured soft symbols, depunctured on the way; ``rows`` (punctured
    rates only; ``None``: the F frames) pads with zero rows to a tile.

    On a CUDA tensor, unless ``plain``: one launch of the framing kernel
    under ``decode.frame`` (the punctured kernel needs a ``clip``).
    Otherwise the plain versions (``kernels.framing``): the clip under
    ``decode.sanitize``, then the framing under ``decode.frame``. At
    punctured rates ``decode.frame`` records ``rate``, the pattern's name,
    and ``symbols``, the stream's length."""
    trace = span_tracer()
    punctured = rate != "1/2"
    attrs = dict(rate=rate, symbols=int(stream.shape[0])) if punctured \
        else {}
    if not punctured:
        if rows is not None:
            raise ValueError("rows pads the frames of punctured rates only")
        stream = stream if stream.ndim == 2 else stream.reshape(n, -1)
    if stream.is_cuda and not plain:
        with trace.span("decode.frame", **attrs):
            if punctured:
                return framing.frame_punctured_cuda(stream, rate, n, spec,
                                                    clip, rows)
            return framing.frame_llr_cuda(stream, spec, clip)
    if clip is not None:
        with trace.span("decode.sanitize"):
            stream = framing.clip_llr_plain(stream, clip)
    with trace.span("decode.frame", **attrs):
        if punctured:
            return framing.frame_punctured_plain(stream, rate, n, spec,
                                                 rows=rows)
        return framing.frame_llr_plain(stream, spec)


def frame_llr(llr: torch.Tensor, spec: FrameSpec, clip: float | None = None,
              *, plain: bool = False) -> torch.Tensor:
    """(n, beta) -> (F, L, beta) frames: ``frame_received`` at rate 1/2."""
    return frame_received(llr, llr.shape[0], spec, clip=clip, plain=plain)


def decode_frame(llr_frame: torch.Tensor, trellis: Trellis,
                 spec: FrameSpec, renorm_every: int = 1) -> torch.Tensor:
    """Decode (..., L, beta) frames -> (..., f) int32 bits (plain torch
    reference path; the JAX package's decode_frame vmapped over ``...``)."""
    sel, sigma, amax = viterbi_forward(llr_frame, trellis,
                                       renorm_every=renorm_every)
    if spec.parallel_tb:
        return parallel_traceback(sel, amax, trellis, spec.v1, spec.f,
                                  spec.f0, spec.v2s, spec.start)
    start = torch.argmax(sigma, dim=-1)
    return serial_traceback(sel, trellis, start, spec.v1, spec.f)


def reframe_blocks(frames: torch.Tensor, spec: FrameSpec, block_frames: int,
                   overlap: int) -> torch.Tensor:
    """(F, L, beta) frames -> (F*B, fb + 2*overlap, beta) block windows.

    Block b covers frame stages ``[v1 + b*fb - overlap, v1 + (b+1)*fb +
    overlap)``, zero-padded where a window reaches past the frame."""
    F = frames.shape[0]
    B, ov = int(block_frames), int(overlap)
    fb = spec.f // B
    pad_l = max(0, ov - spec.v1)
    pad_r = max(0, ov - spec.v2)
    padded = torch.nn.functional.pad(frames, (0, 0, pad_l, pad_r))
    starts = pad_l + spec.v1 - ov + torch.arange(B, device=frames.device) * fb
    # (F, B, Lb, beta)
    blocks = framing.windows(padded, starts, fb + 2 * ov, 1)
    return blocks.reshape(F * B, fb + 2 * ov, frames.shape[2])


def merge_blocks(bits: torch.Tensor, block_frames: int) -> torch.Tensor:
    """(F*B, fb) per-block kept bits -> (F, f) frame bits (a reshape: each
    block already kept only its fb body stages)."""
    FB, fb = bits.shape
    return bits.reshape(FB // int(block_frames), int(block_frames) * fb)


def framed_decode(llr: torch.Tensor, trellis: Trellis, spec: FrameSpec,
                  n_out: int | None = None) -> torch.Tensor:
    """Full framed decode: (n, beta) llr -> (n,) bits."""
    spec.validate()
    n = llr.shape[0] if n_out is None else n_out
    bits = decode_frame(frame_llr(llr, spec), trellis, spec)
    return bits.reshape(-1)[:n]
