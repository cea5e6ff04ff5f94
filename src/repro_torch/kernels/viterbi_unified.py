"""Unified Viterbi decode (paper §IV-A, Alg. 3): port of
``repro.kernels.viterbi_unified``.

The paper's central idea: branch metrics, ACS and traceback in ONE kernel,
so the survivor matrix lives in on-chip memory and never touches device
memory. On Hopper it lives in shared memory and the path metrics in
registers: one thread a frame at 3 <= k <= 7 and beta <= 3 where the
launch's frames fill the card (the thread mapping,
``autotune.thread_mapping``), one warp a frame at the other codes to
k = 11 and at smaller launches (``csrc/viterbi_unified.cu`` and
``csrc/acs.cuh``, whose head notes give the design).

Three functions:

* ``unified_decode_frames`` — the entry the rest of the port calls. A CUDA
  tensor goes to the kernel, a CPU tensor to the plain version. There is no
  fallback: on a CUDA tensor the kernel runs or this raises.
* ``unified_decode_frames_cuda`` — the kernel's wrapper. It checks the
  inputs, allocates the output (and, for frames too long for shared
  memory, a device-memory survivor scratch) and launches on the current
  stream. ``unified_decode_frames_cuda.launches`` counts its launches,
  ``.mapping_launches`` the same by mapping (``autotune.b1_mapping``'s
  names), and ``.last_mapping`` names the mapping of the last launch.
* ``unified_decode_frames_plain`` — the same arithmetic in plain torch
  (``acs.acs_scan``, ``packing``), on any device; the CPU path, and what
  the kernel is held against on the card.

Frames per thread block. ``frames_per_tile`` is the padding granule (the
frame count must be a multiple of it, as in the JAX kernel) and the most
frames one thread block decodes. On the thread mapping a block is one
thread a frame, at most ``autotune.max_frames_per_block`` (256), with
each frame's survivors in a ring of ``autotune.thread_ring_slots`` stages
in the block's shared memory, and fewer frames where their rings would
overflow it; where one frame's ring does not fit, the code runs on the
warp mapping and its device-memory scratch. Otherwise the kernel runs
one warp per frame (a
segment of S lanes for S < 32), at most eight warps a block, so a block
holds at most ``autotune.max_frames_per_block`` frames, and fewer when
their survivors would overflow shared memory; past beta =
``autotune.MAX_BETA`` = 8 the warp takes beta at run time and stages its
LLRs in shared memory too (``autotune.low_rate``). Codes 12 <= k <= 15 run
one frame on a block of ``autotune.large_threads`` threads, path metrics
in shared memory (``acs.cuh``'s ``VitCluster`` on one block; per-edge
branch metrics past beta = 8): the grid is the blocks resident at once
(``autotune.block_grid``), each taking frames in turn, the survivors in
shared memory or in a device-memory scratch per block as
``autotune.block_survivors_on_chip`` says. Every other code the plain
version takes (k > ``autotune.MAX_K`` = 15) runs the wide mapping
(``acs.cuh``'s ``VitWide``): one frame a block, k and beta at run time,
survivors and traceback starts in a device-memory scratch of each
block's, and past k = 15 the path metrics too; the grid is the blocks
resident at once (``autotune.wide_grid``), each taking frames in turn.
Codes 16 <= k <= 19 run it on a thread-block cluster of 2^(k-15) blocks a
frame (``acs.cuh``'s ``VitCluster``, ``autotune.wide_cluster``),
the path metrics in the cluster's shared memory, the scratch per cluster;
the device-memory path metrics are allocated only where the planner keeps
the code off a cluster. Where the card cannot hold that scratch or that
cluster, the allocation, the planner or the launch raises. Bits never
depend on the tile.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.framed import FrameSpec
from ..core.trellis import Trellis
from .acs import BM_DTYPES, acs_scan
from .autotune import (block_grid, block_survivors_on_chip, device_limits,
                       low_rate, max_frames_per_block, smem_mapping,
                       thread_mapping, tile_survivors_on_chip, wide_cluster,
                       wide_grid, wide_mapping)
from .build import build
from .packing import Layout, extract_bit, pack_bits, packed_width
from .tables import kernel_tables

__all__ = ["unified_decode_frames", "unified_decode_frames_cuda",
           "unified_decode_frames_plain", "kernel_library", "device_tables"]

SOURCE = "viterbi_unified.cu"
_LLR_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_tables: dict = {}


def kernel_library():
    """Build (at first use) and load the kernel; returns build.Built."""
    built = build(SOURCE)
    lib = built.lib
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_unified_launch.argtypes = [vp] * 9 + [i] * 17 + [vp]
        lib.viterbi_unified_launch.restype = i
        lib.viterbi_unified_smem_bytes.argtypes = [i] * 8
        lib.viterbi_unified_smem_bytes.restype = ctypes.c_longlong
        lib.viterbi_unified_func_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_unified_func_attrs.restype = i
        lib.viterbi_wide_code.argtypes = [i, i]
        lib.viterbi_wide_code.restype = i
        lib.viterbi_wide_threads.argtypes = [i]
        lib.viterbi_wide_threads.restype = i
        lib.viterbi_device_limits.argtypes = [i, ctypes.POINTER(i)]
        lib.viterbi_device_limits.restype = i
        lib.viterbi_cluster_size.argtypes = [i]
        lib.viterbi_cluster_size.restype = i
        lib.viterbi_cluster_threads.argtypes = [i, i]
        lib.viterbi_cluster_threads.restype = i
        lib.viterbi_cluster_smem_bytes.argtypes = [i, i]
        lib.viterbi_cluster_smem_bytes.restype = ctypes.c_longlong
        lib.viterbi_unified_max_clusters.argtypes = [i, i, i,
                                                     ctypes.POINTER(i)]
        lib.viterbi_unified_max_clusters.restype = i
        lib.viterbi_unified_cluster_attrs.argtypes = [i, i, i,
                                                      ctypes.POINTER(i)]
        lib.viterbi_unified_cluster_attrs.restype = i
        lib.viterbi_block_threads.argtypes = [i, i]
        lib.viterbi_block_threads.restype = i
        lib.viterbi_unified_block_smem_bytes.argtypes = [i] * 6
        lib.viterbi_unified_block_smem_bytes.restype = ctypes.c_longlong
        lib.viterbi_unified_block_occupancy.argtypes = [
            i, i, ctypes.c_longlong, ctypes.POINTER(i)]
        lib.viterbi_unified_block_occupancy.restype = i
        lib.viterbi_unified_block_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_unified_block_attrs.restype = i
        lib.viterbi_thread_code.argtypes = [i, i]
        lib.viterbi_thread_code.restype = i
        lib.viterbi_thread_slots.argtypes = [i, i]
        lib.viterbi_thread_slots.restype = i
        lib.viterbi_unified_thread_smem_bytes.argtypes = [i] * 5
        lib.viterbi_unified_thread_smem_bytes.restype = ctypes.c_longlong
        lib.viterbi_unified_thread_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.viterbi_unified_thread_attrs.restype = i
        lib.viterbi_unified_thread_launch.argtypes = [vp] * 3 + [i] * 13 + [vp]
        lib.viterbi_unified_thread_launch.restype = i
        lib._argtypes_set = True
    return built


def device_tables(trellis: Trellis, device: torch.device):
    """(idx (2,S) int32, sgn (2,S) f32, signs_half (half,beta) f32) on
    ``device``, built once on the host (kernels/tables.py) and cached (the
    wide mapping reads ``device_polys`` instead)."""
    key = (trellis.k, trellis.polys, str(device))
    if key not in _tables:
        _, idx_p, sgn_p, signs_half = kernel_tables(trellis)
        _tables[key] = (
            torch.as_tensor(np.stack(idx_p), dtype=torch.int32).to(device),
            torch.as_tensor(np.stack(sgn_p), dtype=torch.float32).to(device),
            torch.as_tensor(signs_half, dtype=torch.float32).to(device))
    return _tables[key]


def device_polys(trellis: Trellis, device: torch.device) -> torch.Tensor:
    """The generator polynomials (beta,) int32 on ``device``, cached:
    what the wide mapping builds its branch metrics from."""
    key = ("polys", trellis.k, trellis.polys, str(device))
    if key not in _tables:
        _tables[key] = torch.tensor(trellis.polys, dtype=torch.int32,
                                    device=device)
    return _tables[key]


def _check_cluster(cluster, wide=False, block=False):
    """The private mapping overrides: ``_cluster`` None (the planner's), 1
    (the wide mapping off a cluster) or a power of two (the kernel and the
    card decide whether they take it); ``_block`` (the one-block form) with
    neither ``_wide`` nor ``_cluster``."""
    if cluster is not None and (int(cluster) < 1
                                or int(cluster) & (int(cluster) - 1)):
        raise ValueError(f"_cluster must be a power of two, got {cluster}")
    if block and (wide or cluster is not None):
        raise ValueError("_block forces the one-block form: it takes "
                         "neither _wide nor _cluster")


def _check(frames, trellis, v1, f, v2, f0, v2s, start, frames_per_tile,
           radix, layout, bm_dtype):
    if frames.ndim != 3 or frames.shape[2] != trellis.beta:
        raise ValueError(f"frames must be (F, L, beta={trellis.beta}), got "
                         f"{tuple(frames.shape)}")
    if frames.shape[1] != v1 + f + v2:
        raise ValueError(f"frames.shape[1]={frames.shape[1]} != v1+f+v2="
                         f"{v1 + f + v2}")
    if f0 < 1 or f % f0 or v2s > v2 or v2s < 0:
        raise ValueError(f"need f % f0 == 0 and 0 <= v2s <= v2, got f={f} "
                         f"f0={f0} v2s={v2s} v2={v2}")
    if frames.shape[0] % frames_per_tile:
        raise ValueError(f"frame count {frames.shape[0]} is not a multiple "
                         f"of frames_per_tile={frames_per_tile}")
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if start not in ("boundary", "fixed"):
        raise ValueError(f"start must be 'boundary' or 'fixed', got {start!r}")
    Layout(layout)
    if bm_dtype not in BM_DTYPES:
        raise ValueError(f"bm_dtype must be one of {sorted(BM_DTYPES)}, got "
                         f"{bm_dtype!r}")


def unified_decode_frames(frames: torch.Tensor, *, trellis: Trellis,
                          v1: int, f: int, v2: int, f0: int, v2s: int,
                          start: str = "boundary", frames_per_tile: int = 8,
                          pack_survivors: bool = False, radix: int = 2,
                          layout: str = "lane", bm_dtype: str = "float32",
                          interpret: bool = True) -> torch.Tensor:
    """Decode (F, L, beta) LLR frames -> (F, f) int32 bits.

    The serial traceback is the case ``f0=f, v2s=v2, start='boundary'``.
    ``interpret`` is the JAX package's Pallas interpret-mode flag, kept so
    the signatures pair; it has no meaning on CUDA."""
    kw = dict(trellis=trellis, v1=v1, f=f, v2=v2, f0=f0, v2s=v2s,
              start=start, frames_per_tile=frames_per_tile,
              pack_survivors=pack_survivors, radix=radix, layout=layout,
              bm_dtype=bm_dtype)
    if frames.is_cuda:
        return unified_decode_frames_cuda(frames, **kw)
    if frames.device.type != "cpu":
        raise ValueError(f"no unified decode for device {frames.device}")
    return unified_decode_frames_plain(frames, **kw)


def unified_decode_frames_cuda(frames: torch.Tensor, *, trellis: Trellis,
                               v1: int, f: int, v2: int, f0: int, v2s: int,
                               start: str = "boundary",
                               frames_per_tile: int = 8,
                               pack_survivors: bool = False, radix: int = 2,
                               layout: str = "lane",
                               bm_dtype: str = "float32",
                               _wide: bool = False,
                               _cluster: int | None = None,
                               _block: bool = False, _warp: bool = False,
                               _thread: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on ``frames`` (a contiguous CUDA tensor of
    float32, bfloat16 or float16); raises on anything else or if the build
    or the launch fails. ``radix`` and ``layout`` are checked as in JAX but
    have no effect on the card: every stage is one exact radix-2 step, and
    the bits are the same for both. ``_wide`` runs any code on the wide
    mapping, ``_cluster=C`` on a cluster of C blocks (1: on none), and
    ``_block`` on the one-block form (7 <= k <= 15), for the tests that
    hold them against the other mappings; ``_warp`` runs a code of the
    thread mapping on the warp mapping, and ``_thread`` on the thread
    mapping whatever the frame count (``autotune.thread_mapping`` takes
    it only where the frames fill the card)."""
    _check(frames, trellis, v1, f, v2, f0, v2s, start, frames_per_tile,
           radix, layout, bm_dtype)
    _check_cluster(_cluster, _wide, _block)
    if _warp and _thread:
        raise ValueError("_warp and _thread exclude each other")
    if not frames.is_cuda:
        raise ValueError(f"frames must lie on a CUDA device, got "
                         f"{frames.device}")
    if frames.dtype not in _LLR_DTYPES:
        raise ValueError(f"frames dtype must be float32, bfloat16 or "
                         f"float16, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    k, beta = trellis.k, trellis.beta
    lib = kernel_library().lib
    dev = frames.device
    F, L, _ = frames.shape
    if F == 0:
        return torch.empty((0, f), dtype=torch.int32, device=dev)
    S = trellis.num_states
    nsub = f // f0
    pack = int(pack_survivors)
    fixed = int(start == "fixed")
    row = 4 * packed_width(S) if pack else S
    wide = _wide or bool(_cluster) or wide_mapping(trellis)
    block = not wide and (_block or smem_mapping(trellis))
    if not (wide or block or _warp) and thread_mapping(
            trellis, frames=None if _thread else F, device=dev):
        out = _launch_thread(frames, trellis, v1, f, f0, v2s, fixed,
                             frames_per_tile, bm_dtype)
        if out is not None:
            return out
    pm, C = None, 1
    if wide:             # a block's (a cluster's) survivors and starts
        C = _cluster or wide_cluster(trellis, dev)
        grid = nframes = wide_grid(trellis, F, dev, cluster=C)
        fpb, glob = 1, True
        if C == 1:
            pm = torch.empty((grid, 2, S), dtype=torch.float32, device=dev)
    elif block:          # on chip, or a block's survivors and starts
        spec = FrameSpec(f=f, v1=v1, v2=v2, f0=f0, v2s=v2s, start=start)
        fpb = 1
        glob = not block_survivors_on_chip(
            trellis, spec, pack_survivors=pack_survivors, frames=F,
            device=dev)
        grid = nframes = block_grid(
            trellis, F, dev, smem=lib.viterbi_unified_block_smem_bytes(
                k, L, nsub, pack, fixed, int(glob)))
    else:
        grid = 0
        limit = device_limits(dev).smem_per_block
        cap = min(frames_per_tile, max_frames_per_block(trellis, warp=True),
                  F)
        fpb = cap
        while fpb and lib.viterbi_unified_smem_bytes(
                k, beta, L, nsub, pack, fixed, fpb, 0) > limit:
            fpb -= 1
        # survivors too long for on-chip, or past beta = 8 costing
        # resident frames
        glob = fpb == 0 or low_rate(trellis) and not tile_survivors_on_chip(
            trellis, FrameSpec(f=f, v1=v1, v2=v2, f0=f0, v2s=v2s,
                               start=start), fpb,
            pack_survivors=pack_survivors, frames=F, device=dev)
        if glob:
            fpb = cap
        nframes = -(-F // fpb) * fpb
    idx, sgn, signs_half = device_tables(trellis, dev)
    polys = device_polys(trellis, dev)
    out = torch.empty((F, f), dtype=torch.int32, device=dev)
    sel = amax = None
    if glob:
        sel = torch.empty((nframes, L, row), dtype=torch.uint8, device=dev)
        amax = torch.empty((nframes, nsub), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.viterbi_unified_launch(
            frames.data_ptr(), idx.data_ptr(), sgn.data_ptr(),
            signs_half.data_ptr(), polys.data_ptr(), out.data_ptr(),
            sel.data_ptr() if glob else None,
            amax.data_ptr() if glob else None,
            pm.data_ptr() if pm is not None else None,
            F, L, beta, k, v1, f, f0, v2s, _LLR_DTYPES[frames.dtype], fixed,
            pack, int(bm_dtype == "bfloat16"), fpb, int(wide), grid, C,
            int(block), stream)
    if err != 0:
        raise RuntimeError(f"viterbi_unified launch failed: CUDA error {err}")
    _count("cluster" if C > 1 else "wide" if wide else
           "block" if block else "warp")
    return out


def _count(mapping: str) -> None:
    unified_decode_frames_cuda.launches += 1
    unified_decode_frames_cuda.mapping_launches[mapping] += 1
    unified_decode_frames_cuda.last_mapping = mapping


unified_decode_frames_cuda.launches = 0
#: Launches by the mapping they ran on (autotune.b1_mapping's names).
unified_decode_frames_cuda.mapping_launches = dict.fromkeys(
    ("thread", "warp", "block", "cluster", "wide"), 0)
#: The mapping of the last launch (None before the first).
unified_decode_frames_cuda.last_mapping = None


def thread_coefficients(trellis: Trellis) -> np.ndarray:
    """The thread mapping's edge coefficients, (2, S, 2^(beta-1)) float32:
    edge p into state s has the metric sum_h coef[p, s, h] * bm_half[h],
    coef[p, s, idx_p[s]] = sgn_p[s] and 0 elsewhere (kernels/tables.py)."""
    _, idx_p, sgn_p, _ = kernel_tables(trellis)
    half = 1 << (trellis.beta - 1)
    coef = np.zeros((2, trellis.num_states, half), dtype=np.float32)
    for p in (0, 1):
        coef[p, np.arange(trellis.num_states), idx_p[p]] = sgn_p[p]
    return coef


def both_taps(trellis: Trellis) -> bool:
    """Whether every polynomial has its bottom and top taps (bits 0 and
    k - 1): then a butterfly's four edges are one metric and its
    negation."""
    top = 1 << (trellis.k - 1)
    return all(g & 1 and g & top for g in trellis.polys)


def _thread_tables(trellis: Trellis):
    key = ("thread", trellis.k, trellis.polys)
    if key not in _tables:
        coef = np.ascontiguousarray(thread_coefficients(trellis))
        _tables[key] = (coef, int(both_taps(trellis)))
    return _tables[key]


def _launch_thread(frames, trellis, v1, f, f0, v2s, fixed, frames_per_tile,
                   bm_dtype):
    """B1's thread mapping: blocks of ``frames_per_tile`` frames (at most
    ``autotune.max_frames_per_block``), halved until their survivor rings
    fit the block's shared memory; None, launching nothing, where one
    frame's does not."""
    lib = kernel_library().lib
    dev = frames.device
    F, L, _ = frames.shape
    k, beta = trellis.k, trellis.beta
    limit = device_limits(dev).smem_per_block
    fpb = min(frames_per_tile, max_frames_per_block(trellis), F)
    while fpb and lib.viterbi_unified_thread_smem_bytes(
            k, beta, f0, v2s, fpb) > limit:
        fpb //= 2
    if not fpb:
        return None
    coef, taps = _thread_tables(trellis)
    out = torch.empty((F, f), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.viterbi_unified_thread_launch(
            frames.data_ptr(), coef.ctypes.data, out.data_ptr(), F, L,
            beta, k, v1, f, f0, v2s,
            _LLR_DTYPES[frames.dtype], fixed, int(bm_dtype == "bfloat16"),
            taps, fpb, stream)
    if err != 0:
        raise RuntimeError(f"viterbi_unified thread launch failed: CUDA "
                           f"error {err}")
    _count("thread")
    return out


def unified_decode_frames_plain(frames: torch.Tensor, *, trellis: Trellis,
                                v1: int, f: int, v2: int, f0: int, v2s: int,
                                start: str = "boundary",
                                frames_per_tile: int = 8,
                                pack_survivors: bool = False, radix: int = 2,
                                layout: str = "lane",
                                bm_dtype: str = "float32") -> torch.Tensor:
    """The kernel's arithmetic in plain torch, on any device."""
    _check(frames, trellis, v1, f, v2, f0, v2s, start, frames_per_tile,
           radix, layout, bm_dtype)
    S = trellis.num_states
    kshift = trellis.k - 2
    F, L, _ = frames.shape
    nsub = f // f0
    sels, amaxs = [], []

    def store(t, sel, sigma):
        sels.append(pack_bits(sel) if pack_survivors else sel.to(torch.int32))
        amaxs.append(torch.argmax(sigma, dim=1).to(torch.int32))

    acs_scan(frames.to(torch.float32), trellis=trellis, L=L, radix=radix,
             store=store, bm_dtype=bm_dtype)
    sel_all = torch.stack(sels, 1)                   # (F, L, W|S)
    amax_all = torch.stack(amaxs, 1)                 # (F, L)

    e = v1 + (torch.arange(nsub, device=frames.device) + 1) * f0 - 1 + v2s
    if start == "boundary":
        states = amax_all[:, e]                      # (F, nsub)
    else:
        states = torch.zeros((F, nsub), dtype=torch.int32,
                             device=frames.device)
    tb = []
    for r in range(f0 + v2s):
        tb.append(states >> kshift)                  # bits at stages e - r
        rows = sel_all[:, e - r]                     # (F, nsub, W|S)
        if pack_survivors:
            p = extract_bit(rows, states)
        else:
            p = torch.gather(rows, 2, states[..., None].to(torch.long))[..., 0]
        states = ((states << 1) & (S - 1)) | p
    kept = torch.stack(tb[v2s:][::-1], -1)           # (F, nsub, f0) ascending
    return kept.reshape(F, f).to(torch.int32)
