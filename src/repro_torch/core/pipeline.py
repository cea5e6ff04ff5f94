"""End-to-end decode API, the paper's receiver path: port of
``repro.core.pipeline``.

clip, depuncture and frame -> decode -> stitch. ``make_decoder`` takes one
path at every rate and on every device: ``core.framed.frame_received``, the
one front end, turns the received stream into frames (a kernel launch on
the card, its plain version elsewhere), and the frame decoder decodes
them. ``make_frame_decoder`` exposes the frames -> bits core with one
backend dispatch, and alone knows the tile:

* ``reference`` — the plain torch reference decoder;
* ``kernel`` — the unified CUDA kernel (survivors on chip);
* ``kernel_split`` — the split path, the prior-work baseline: the forward
  CUDA kernel streams survivors to device memory and the traceback CUDA
  kernel reads them back.

Device. ``make_decoder`` and ``make_frame_decoder`` take ``device=None``,
which means ``"cuda"``; without a card they raise unless ``device="cpu"``
is given. On the CPU the kernel backends run the kernels' plain torch
versions.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from ..obs.profiled import span_tracer
from .framed import FrameSpec, decode_frame, frame_received
from .puncture import check_alignment
from .sanitize import LLR_CLIP as _LLR_CLIP
from .trellis import STD_K7, Trellis

__all__ = ["DecoderConfig", "make_decoder", "make_frame_decoder"]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Everything needed to build a decode function (same fields and
    validation as the JAX package's DecoderConfig).

    Every kernel knob decodes bit-identically to the reference backend,
    except ``bm_dtype='bfloat16'`` (branch metrics rounded once; BER-neutral
    to within 1e-3) and ``block_frames``/``overlap`` (intra-frame
    block-parallel decode, a truncated traceback applied by all backends,
    reference included, so kernel and reference stay bit-identical).

    ``interpret`` (Pallas interpret mode) is kept so configurations and
    checkpoints carry over unchanged between the two packages; it changes
    nothing that CUDA runs.
    ``frames_per_tile`` is the kernel's frames per thread block (``"auto"``
    = the tile planner's choice, kernels/autotune.py). ``layout`` orients
    the ``kernel_split`` survivor stream in device memory. ``renorm_every``
    != 1 is a reference-backend knob, as in the JAX package.
    """
    trellis: Trellis = STD_K7
    spec: FrameSpec = FrameSpec()
    rate: str = "1/2"
    backend: str = "reference"     # 'reference' | 'kernel' | 'kernel_split'
    interpret: bool = True         # Pallas interpret mode; no meaning on CUDA
    pack_survivors: bool = True    # bit-pack survivors 32x (kernel backends)
    radix: int = 4                 # 2 | 4 trellis stages per ACS step
    frames_per_tile: int | str = "auto"   # frames per thread block
    layout: str = "lane"           # 'lane' | 'sublane' split survivor stream
    bm_dtype: str = "float32"      # 'float32' | 'bfloat16' branch metrics
    renorm_every: int = 1          # path-metric renormalization period
    block_frames: int | str = 1    # intra-frame blocks per frame, or 'auto'
    overlap: int | None = None     # block training/truncation stages

    def __post_init__(self):
        if self.rate != "1/2":
            check_alignment(self.spec.f, self.spec.v1, self.spec.v2, self.rate)
        if self.radix not in (2, 4):
            raise ValueError(f"radix must be 2 or 4, got {self.radix}")
        if self.layout not in ("lane", "sublane"):
            raise ValueError(f"layout must be 'lane' or 'sublane', "
                             f"got {self.layout!r}")
        if self.bm_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bm_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.bm_dtype!r}")
        if self.renorm_every < 0:
            raise ValueError(f"renorm_every must be >= 0, "
                             f"got {self.renorm_every}")
        if self.renorm_every != 1 and self.backend != "reference":
            raise ValueError(
                "renorm_every != 1 requires backend='reference' (the "
                "kernels renormalize every stage unconditionally)")
        if not (self.block_frames == "auto"
                or (isinstance(self.block_frames, int)
                    and self.block_frames >= 1)):
            raise ValueError(
                f"block_frames must be 'auto' or an int >= 1, "
                f"got {self.block_frames!r}")
        if self.overlap is not None and self.overlap < 0:
            raise ValueError(f"overlap must be >= 0, got {self.overlap}")
        if (self.block_frames not in (1, "auto")
                or self.overlap is not None):
            from ..kernels.block import resolve_block
            resolve_block(self.trellis, self.spec, self.block_frames,
                          self.overlap)


def _build_frame_decoder(cfg: DecoderConfig, device: torch.device):
    from ..kernels.block import merge_blocks, reframe_blocks, resolve_block
    bf, ov = resolve_block(cfg.trellis, cfg.spec, cfg.block_frames,
                           cfg.overlap)
    if cfg.backend == "reference":
        # the reference applies the same block decomposition as the
        # kernels, so kernel and reference stay bit-identical
        sub = cfg.spec.blocked(bf, ov) if bf > 1 else cfg.spec

        def decode_frames(frames, frames_per_tile=None):   # no tile here
            frames = torch.as_tensor(frames).to(device)
            if bf > 1:
                frames = reframe_blocks(frames, cfg.spec, bf, ov)
            bits = decode_frame(frames, cfg.trellis, sub, cfg.renorm_every)
            return merge_blocks(bits, bf) if bf > 1 else bits

        def tiling(F):
            return F, cfg.frames_per_tile
    elif cfg.backend in ("kernel", "kernel_split"):
        from ..kernels import ops as kops
        knobs = dict(unified=cfg.backend == "kernel",
                     pack_survivors=cfg.pack_survivors, radix=cfg.radix,
                     layout=cfg.layout, bm_dtype=cfg.bm_dtype)

        def decode_frames(frames, frames_per_tile=cfg.frames_per_tile):
            return kops.viterbi_decode_frames(
                frames, cfg.trellis, cfg.spec,
                frames_per_tile=frames_per_tile, block_frames=bf,
                overlap=ov, interpret=cfg.interpret, device=device, **knobs)

        def tiling(F):
            tile = cfg.frames_per_tile
            if bf > 1:          # the block reframe pads after the framing
                return F, tile
            if tile == "auto":
                tile = kops.plan_frames_per_tile(cfg.trellis, cfg.spec, F,
                                                 device=device, **knobs)
            return kops.tile_rows(F, tile), tile
    else:
        raise ValueError(cfg.backend)
    decode_frames.tiling = tiling
    return decode_frames


def make_frame_decoder(cfg: DecoderConfig, device=None):
    """Returns decode_frames(frames (F, L, beta)) -> (F, f) int32 bits on
    ``device`` (``None`` = ``"cuda"``). ``decode_frames.tiling(F)`` gives
    the (rows, tile) a launch over F frames decodes, for a caller that
    frames straight into the tile's rows and passes the tile back as
    ``frames_per_tile``: the planned tile (``decode.plan``) and its
    multiple of rows for the kernel backends without block reframing, F
    rows and ``cfg.frames_per_tile`` otherwise. Memoized per (cfg, device) in the
    process-global plan cache (serve.plan_cache), as in the JAX package:
    every caller, the stream and serve layers included, gets the same
    closure."""
    from ..serve.plan_cache import PLAN_CACHE
    return PLAN_CACHE.frame_decoder(cfg, device=device)


def make_decoder(cfg: DecoderConfig, device=None):
    """Returns decode(stream, n) -> (n,) int32 bits on ``device``
    (``None`` = ``"cuda"``). ``stream`` is the punctured soft-symbol stream
    (m,) for rate != 1/2, or (n, beta) LLRs; numpy or torch.

    Each call runs under a ``decode`` span (attribute ``call``, the
    decoder's sequence number of the call), with ``decode.copy_in`` and
    ``core.framed.frame_received``'s spans inside it (the clip and the
    framing: one kernel launch under ``decode.frame`` on the card in the
    kernel backends, else ``decode.sanitize`` and then ``decode.frame``),
    and the frame decoder's spans after. At punctured rates the frame
    decoder's ``tiling`` plans the tile first (``decode.plan``), and the
    frames are written already padded to it; at rate 1/2 the frame decoder
    plans after the framing launch, which it overlaps on the card.
    """
    from ..kernels import ops as kops
    dev = kops.resolve_device(device)
    decode_frames = make_frame_decoder(cfg, dev)
    # input hardening (core.sanitize): NaN/Inf -> neutral zero,
    # |llr| > clip -> ±clip; the identity on clean in-range inputs. The
    # reference backend keeps the plain torch ops on every device.
    plain = cfg.backend == "reference"
    calls = itertools.count()

    def decode(stream, n: int) -> torch.Tensor:
        trace = span_tracer()
        with trace.span("decode", call=next(calls)):
            with trace.span("decode.copy_in"):
                stream = torch.as_tensor(stream).to(dev)
            rows, tile = None, cfg.frames_per_tile
            if cfg.rate != "1/2":
                rows, tile = decode_frames.tiling(cfg.spec.num_frames(n))
            frames = frame_received(stream, n, cfg.spec, cfg.rate,
                                    _LLR_CLIP, rows, plain=plain)
            bits = decode_frames(frames, frames_per_tile=tile)  # (rows, f)
            return bits.reshape(-1)[:n]

    return decode
