"""Forward-only Viterbi kernel, the prior-work baseline (paper Table I row
b): port of ``repro.kernels.viterbi_fwd``.

Same branch metrics and ACS as the unified kernel, but the survivor
selectors and every stage's argmax state are streamed to device memory
and traced back by a separate kernel (``kernels.traceback_frames``). It
exists so that the unified kernel's saving is measurable: the survivor
stream here is F * L * S bytes (F * L * ceil(S/32) * 4 packed), written
and read back; in the unified kernel it never leaves the chip. The CUDA
source is ``csrc/viterbi_fwd.cu``, whose head note gives the design.

``layout`` orients the stream as the JAX kernel does, and here it changes
the output:

* lane    — frame-major: (F, L, W) int32 packed / (F, L, S) int8;
* sublane — frames trailing: (L*W, F) int32 packed / (L, S, F) int8.

``amax`` is (F, L) int32 in both: the first maximal state of each stage.

Three functions, as in ``viterbi_unified``:

* ``forward_frames`` dispatches by the tensor's device: a CUDA tensor to
  the kernel, a CPU tensor to the plain version, no fallback;
* ``forward_frames_cuda`` checks, allocates the outputs, launches on the
  current stream, raises on any failure and counts ``.launches``;
* ``forward_frames_plain`` is the same arithmetic in plain torch
  (``acs.acs_scan``, ``packing``), on any device.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.trellis import Trellis
from .acs import BM_DTYPES, acs_scan
from .autotune import (block_grid, max_frames_per_block, smem_mapping,
                       wide_cluster, wide_grid, wide_mapping)
from .build import build
from .packing import Layout, pack_bits, packed_width
from .viterbi_unified import (_LLR_DTYPES, _check_cluster, device_polys,
                              device_tables)

__all__ = ["forward_frames", "forward_frames_cuda", "forward_frames_plain",
           "kernel_library"]

SOURCE = "viterbi_fwd.cu"


def kernel_library():
    """Build (at first use) and load the kernel; returns build.Built."""
    built = build(SOURCE)
    lib = built.lib
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_fwd_launch.argtypes = [vp] * 8 + [i] * 13 + [vp]
        lib.viterbi_fwd_launch.restype = i
        lib.viterbi_fwd_smem_bytes.argtypes = [i, i, i]
        lib.viterbi_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.viterbi_fwd_func_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_fwd_func_attrs.restype = i
        lib.viterbi_fwd_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.viterbi_fwd_max_clusters.restype = i
        lib.viterbi_fwd_cluster_attrs.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.viterbi_fwd_cluster_attrs.restype = i
        lib.viterbi_fwd_block_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_fwd_block_occupancy.restype = i
        lib.viterbi_fwd_block_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_fwd_block_attrs.restype = i
        lib._argtypes_set = True
    return built


def _check(frames, trellis, frames_per_tile, radix, layout, bm_dtype):
    if frames.ndim != 3 or frames.shape[2] != trellis.beta:
        raise ValueError(f"frames must be (F, L, beta={trellis.beta}), got "
                         f"{tuple(frames.shape)}")
    if frames.shape[0] % frames_per_tile:
        raise ValueError(f"frame count {frames.shape[0]} is not a multiple "
                         f"of frames_per_tile={frames_per_tile}")
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if bm_dtype not in BM_DTYPES:
        raise ValueError(f"bm_dtype must be one of {sorted(BM_DTYPES)}, got "
                         f"{bm_dtype!r}")
    return Layout(layout)


def forward_frames(frames: torch.Tensor, *, trellis: Trellis,
                   frames_per_tile: int = 8, pack_survivors: bool = False,
                   radix: int = 2, layout: str = "lane",
                   bm_dtype: str = "float32", interpret: bool = True):
    """(F, L, beta) LLRs -> (sel, amax (F, L) int32), laid out as the
    module docstring says. ``interpret`` is the JAX package's Pallas flag,
    kept so the signatures pair; it has no meaning on CUDA."""
    kw = dict(trellis=trellis, frames_per_tile=frames_per_tile,
              pack_survivors=pack_survivors, radix=radix, layout=layout,
              bm_dtype=bm_dtype)
    if frames.is_cuda:
        return forward_frames_cuda(frames, **kw)
    if frames.device.type != "cpu":
        raise ValueError(f"no forward kernel for device {frames.device}")
    return forward_frames_plain(frames, **kw)


def forward_frames_cuda(frames: torch.Tensor, *, trellis: Trellis,
                        frames_per_tile: int = 8,
                        pack_survivors: bool = False, radix: int = 2,
                        layout: str = "lane", bm_dtype: str = "float32",
                        _wide: bool = False, _cluster: int | None = None,
                        _block: bool = False):
    """Launch the CUDA kernel on ``frames`` (a contiguous CUDA tensor of
    float32, bfloat16 or float16); raises on anything else or if the build
    or the launch fails. A block holds at most ``frames_per_tile`` and at
    most ``autotune.max_frames_per_block`` frames; a large code (12 <= k <=
    15) runs one frame a block at a time on the blocks resident at once
    (``autotune.block_grid``); past beta = 8 both take beta at run time; a
    code past k = 15, and K=9 past beta = 8 (``autotune.FWD_WIDE_K``),
    runs the wide mapping (one frame a block, the grid the
    blocks resident at once, each block's path metrics in a device-memory
    scratch; at 16 <= k <= 19 a cluster of 2^(k-15) blocks a frame, path
    metrics in the cluster's shared memory, where the card holds one).
    ``radix`` is checked as in JAX but has no effect on the card: every
    stage is one exact radix-2 step, and the outputs are the same for
    both. ``_wide`` runs any code on the wide mapping,
    ``_cluster=C`` on a cluster of C blocks (1: on none), and ``_block`` on
    the one-block form (7 <= k <= 15), for the tests that hold them
    against the other mappings."""
    lay = _check(frames, trellis, frames_per_tile, radix, layout, bm_dtype)
    _check_cluster(_cluster, _wide, _block)
    if not frames.is_cuda:
        raise ValueError(f"frames must lie on a CUDA device, got "
                         f"{frames.device}")
    if frames.dtype not in _LLR_DTYPES:
        raise ValueError(f"frames dtype must be float32, bfloat16 or "
                         f"float16, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    k, beta = trellis.k, trellis.beta
    dev = frames.device
    F, L, _ = frames.shape
    S = trellis.num_states
    W = packed_width(S)
    sub = lay is Layout.SUBLANE
    if pack_survivors:
        shape = (L * W, F) if sub else (F, L, W)
        sel = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        shape = (L, S, F) if sub else (F, L, S)
        sel = torch.empty(shape, dtype=torch.int8, device=dev)
    amax = torch.empty((F, L), dtype=torch.int32, device=dev)
    if F == 0:
        return sel, amax
    lib = kernel_library().lib
    wide = _wide or bool(_cluster) or (
        not _block and wide_mapping(trellis, unified=False))
    block = not wide and (_block or smem_mapping(trellis))
    pm, C = None, 1
    if wide:
        C = _cluster or wide_cluster(trellis, dev, unified=False)
        fpb, grid = 1, wide_grid(trellis, F, dev, unified=False, cluster=C)
        if C == 1:
            pm = torch.empty((grid, 2, S), dtype=torch.float32, device=dev)
    elif block:
        fpb, grid = 1, block_grid(trellis, F, dev, unified=False)
    else:
        fpb = min(frames_per_tile, max_frames_per_block(trellis, False), F)
        grid = 0
    idx, sgn, signs_half = device_tables(trellis, dev)
    polys = device_polys(trellis, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.viterbi_fwd_launch(
            frames.data_ptr(), idx.data_ptr(), sgn.data_ptr(),
            signs_half.data_ptr(), polys.data_ptr(), sel.data_ptr(),
            amax.data_ptr(), pm.data_ptr() if pm is not None else None,
            F, L, beta, k, _LLR_DTYPES[frames.dtype], int(pack_survivors),
            int(sub), int(bm_dtype == "bfloat16"), fpb, int(wide), grid, C,
            int(block), stream)
    if err != 0:
        raise RuntimeError(f"viterbi_fwd launch failed: CUDA error {err}")
    forward_frames_cuda.launches += 1
    forward_frames_cuda.last_mapping = ("cluster" if C > 1 else "wide" if wide
                                        else "block" if block else "warp")
    return sel, amax


forward_frames_cuda.launches = 0
#: The mapping of the last launch (autotune.b1_mapping's names; None
#: before the first).
forward_frames_cuda.last_mapping = None


def forward_frames_plain(frames: torch.Tensor, *, trellis: Trellis,
                         frames_per_tile: int = 8,
                         pack_survivors: bool = False, radix: int = 2,
                         layout: str = "lane", bm_dtype: str = "float32"):
    """The kernel's arithmetic in plain torch, on any device."""
    lay = _check(frames, trellis, frames_per_tile, radix, layout, bm_dtype)
    F, L, _ = frames.shape
    sels, amaxs = [], []

    def store(t, sel, sigma):
        sels.append(sel)
        amaxs.append(torch.argmax(sigma, dim=1).to(torch.int32))

    acs_scan(frames.to(torch.float32), trellis=trellis, L=L, radix=radix,
             store=store, bm_dtype=bm_dtype)
    sel = torch.stack(sels, 1)                       # (F, L, S) bool
    amax = torch.stack(amaxs, 1)                     # (F, L)
    sel = pack_bits(sel) if pack_survivors else sel.to(torch.int8)
    if lay is Layout.SUBLANE:                        # frames trailing
        sel = sel.permute(1, 2, 0).contiguous()      # (L, W|S, F)
        if pack_survivors:
            sel = sel.reshape(-1, F)                 # (L*W, F)
    return sel, amax
