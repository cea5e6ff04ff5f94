"""Public decode call over the kernels: port of ``repro.kernels.ops``.

Validates the frames, resolves ``frames_per_tile="auto"`` through the
tile planner (kernels/autotune.py, for the kernel that will run; the
``decode.plan`` span), moves the frames to the device, applies the
intra-frame block reframe and pads the frame count to the tile (the
``decode.pad`` span; a caller that frames already padded plans first with
``plan_frames_per_tile`` and passes the tile, as the frame decoder's
``tiling`` does for the punctured receiver call, and then there is nothing
to pad), encodes the serial traceback as one subframe (``f0=f, v2s=v2``)
and dispatches under the ``decode.kernel`` span, whose attributes are the
launch's knobs and ``mapping``, the mapping the decode kernel ran on as
its wrapper recorded it (``autotune.b1_mapping``'s names: "thread",
"warp", "block", "cluster" or "wide"; "plain" off the card):

* ``unified=True``  — the unified kernel: survivors never leave the chip;
* ``unified=False`` — the split path, the prior-work baseline: the forward
  kernel streams survivors and per-stage argmax to device memory in the
  chosen layout, and the traceback kernel reads them back.
"""
from __future__ import annotations

import torch

from ..core.framed import FrameSpec, merge_blocks, reframe_blocks
from ..core.trellis import Trellis
from ..obs.profiled import span_tracer
from .autotune import plan_tiles
from .packing import Layout
from .traceback_frames import traceback_frames
from .viterbi_fwd import forward_frames, forward_frames_cuda
from .viterbi_unified import unified_decode_frames, unified_decode_frames_cuda

__all__ = ["viterbi_decode_frames", "resolve_device", "plan_frames_per_tile",
           "tile_rows"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a usable card
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch version")
    return dev


def plan_frames_per_tile(trellis: Trellis, spec: FrameSpec, frames: int, *,
                         unified: bool, pack_survivors: bool, radix: int,
                         layout, bm_dtype: str, device) -> int:
    """The tile planner's frames per block for a launch over ``frames``
    frames of ``spec`` (``layout`` a ``Layout`` or its name), under the
    ``decode.plan`` span."""
    with span_tracer().span("decode.plan"):
        return plan_tiles(
            trellis, spec, pack_survivors=pack_survivors, radix=radix,
            unified=unified, layout=Layout(layout), bm_dtype=bm_dtype,
            max_frames=frames, device=device).frames_per_tile


def tile_rows(frames: int, tile: int) -> int:
    """The rows a launch over ``frames`` frames decodes: the next multiple
    of the tile."""
    return -(-frames // tile) * tile


def _pad_frames(frames: torch.Tensor, tile: int):
    F = frames.shape[0]
    Fp = tile_rows(F, tile)
    if Fp != F:
        frames = torch.nn.functional.pad(frames, (0, 0, 0, 0, 0, Fp - F))
    return frames, F


def _launched_mapping(frames: torch.Tensor, unified: bool):
    """The mapping the decode kernel just ran ``frames`` on, as its
    wrapper recorded it; "plain" off the card, None for no frames."""
    if not frames.is_cuda:
        return "plain"
    if not frames.shape[0]:
        return None
    return (unified_decode_frames_cuda if unified
            else forward_frames_cuda).last_mapping


def viterbi_decode_frames(frames, trellis: Trellis, spec: FrameSpec, *,
                          unified: bool = True,
                          frames_per_tile: int | str = "auto",
                          pack_survivors: bool = True, radix: int = 4,
                          layout: str = "lane", bm_dtype: str = "float32",
                          block_frames: int = 1, overlap: int = 0,
                          interpret: bool = True,
                          device=None) -> torch.Tensor:
    """(F, L, beta) LLR frames -> (F, f) int32 decoded bits, on ``device``
    (``None`` = ``"cuda"``; frames are moved there).

    Knobs as in the JAX package: every combination decodes bit-identically
    to the reference except ``bm_dtype='bfloat16'`` (branch metrics rounded
    once) and ``block_frames > 1`` (truncated traceback per block, exact
    when ``overlap >= block.full_overlap``). ``layout`` orients the split
    path's survivor stream in device memory (lane: frame-major; sublane:
    frames trailing) and is recorded without effect by the unified
    kernel, whose survivors stay on chip. ``interpret`` is a TPU knob,
    recorded and without effect here."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames)
    spec.validate()
    if frames.ndim != 3:
        raise ValueError(
            f"frames must be (F, L, beta), got {frames.ndim}-D "
            f"{tuple(frames.shape)}")
    if frames.shape[1] != spec.frame_len:
        raise ValueError(
            f"frames.shape[1]={frames.shape[1]} != spec.frame_len="
            f"{spec.frame_len} (v1 + f + v2 overlap window)")
    if frames.shape[2] != trellis.beta:
        raise ValueError(
            f"frames.shape[2]={frames.shape[2]} != trellis.beta="
            f"{trellis.beta} coded bits per stage")
    if not frames.dtype.is_floating_point:
        raise ValueError(
            f"frames must be floating-point LLRs, got dtype {frames.dtype}")
    F_in = frames.shape[0]
    if block_frames < 1:
        raise ValueError(f"block_frames must be >= 1, got {block_frames}")
    sub = spec.blocked(block_frames, overlap) if block_frames > 1 else spec
    lay = Layout(layout)
    trace = span_tracer()
    if frames_per_tile == "auto":
        frames_per_tile = plan_frames_per_tile(
            trellis, sub, F_in * block_frames, unified=unified,
            pack_survivors=pack_survivors, radix=radix, layout=lay,
            bm_dtype=bm_dtype, device=dev)
    with trace.span("decode.pad"):
        frames = frames.to(dev)
        if frames.dtype == torch.float64:  # the kernel reads f32/bf16/f16
            frames = frames.to(torch.float32)
        if block_frames > 1:
            frames = reframe_blocks(frames, spec, block_frames, overlap)
        padded, F = _pad_frames(frames.contiguous(), frames_per_tile)
    spec = sub
    # serial traceback == one subframe spanning the kept region
    f0 = spec.f0 if spec.parallel_tb else spec.f
    v2s = spec.v2s if spec.parallel_tb else spec.v2
    start = spec.start if spec.parallel_tb else "boundary"

    # the launch's knobs, built only for a tracer that keeps them
    knobs = dict(
        kernel="unified" if unified else "split", frames=int(F),
        frames_per_tile=int(frames_per_tile), layout=lay.value,
        bm_dtype=str(bm_dtype), radix=int(radix),
        pack_survivors=bool(pack_survivors), block_frames=int(block_frames),
        overlap=int(overlap), interpret=bool(interpret),
        device=str(dev)) if trace.enabled else {}
    with trace.span("decode.kernel", **knobs) as span:
        if unified:
            bits = unified_decode_frames(
                padded, trellis=trellis, v1=spec.v1, f=spec.f, v2=spec.v2,
                f0=f0, v2s=v2s, start=start,
                frames_per_tile=frames_per_tile,
                pack_survivors=pack_survivors, radix=radix,
                layout=lay.value, bm_dtype=bm_dtype)[:F]
        else:
            sel, amax = forward_frames(
                padded, trellis=trellis, frames_per_tile=frames_per_tile,
                pack_survivors=pack_survivors, radix=radix,
                layout=lay.value, bm_dtype=bm_dtype)
            # the device-memory round trip; the sublane stream keeps frames
            # on the trailing axis
            if lay is Layout.SUBLANE:
                sel = sel[..., :F]
            else:
                sel = sel[:F]
            bits = traceback_frames(
                sel, amax[:F], trellis=trellis, v1=spec.v1, f=spec.f, f0=f0,
                v2s=v2s, start=start, packed=pack_survivors,
                layout=lay.value)
        if trace.enabled:
            span.set(mapping=_launched_mapping(padded, unified))
    if block_frames > 1:
        bits = merge_blocks(bits, block_frames)       # (F_in, f)
        assert bits.shape[0] == F_in
    return bits
