"""Shared-memory, register and occupancy tile planner for the port's CUDA
kernels: port of ``repro.kernels.autotune``.

A tile is the number of frames one thread block decodes
(``frames_per_tile``, also the frame-count padding granule). On the TPU it
was a memory decision: as many frames per grid step as a VMEM budget
allows. On Hopper both kernels run one warp per frame with the path
metrics in registers (32 / S frames per warp when S < 32), and a block is
at most ``BLOCK_THREADS`` = 256 threads, so a block holds at most
``max_frames_per_block`` frames (the thread cap). Nothing in the kernels'
stage loop is block-wide: a block is only a unit of scheduling. Its shared
memory is the kernel's own carve-up, which ``unified_smem_bytes`` /
``split_smem_bytes`` reproduce term for term (the kernels export the same
numbers: ``viterbi_unified_smem_bytes``, ``viterbi_fwd_smem_bytes``; the
card tests hold them equal): the unified kernel keeps its survivors and
traceback starts there, the forward kernel nothing. A tile fits when its
block's shared memory is within the budget: by default the per-block
opt-in limit, queried on the card, and on the CPU the H100's 227 KB
(``H100_LIMITS``).

``plan_tiles`` then picks, among the fitting power-of-two tiles up to the
thread cap, the one that keeps the most frames resident on an SM, and
among those the smallest. Blocks per SM are limited by the SM's threads,
its block slots, its shared memory with the runtime's per-block reserve,
and its registers: each kernel instantiation's register count, which the
kernels export from ``cudaFuncGetAttributes``
(``viterbi_*_func_attrs``). On the CPU every code plans with
``H100_REGISTERS``, each kernel's count at K=7 beta=2 recorded from the
card: there the tile only sets the padding, and a plan for another code
may differ from the card's. With the path metrics in registers,
registers bound the resident frames of most codes. Resident
frames are what hides the latency of each stage's dependent chain (the
butterfly's shuffles and the max's redux). If no tile fits, the smallest
is returned (``fits`` is false): the unified kernel then keeps its
survivors in device memory.

B1 runs the codes 3 <= k <= 7 at beta <= 3 (``thread_mapping``) on its
thread mapping instead wherever a launch's frames fill the card
(``THREAD_MIN_FRAMES_PER_SM`` an SM; below that the planner and the
wrapper both keep the warp mapping, ``warp=True`` in the models): one
thread a frame, so a block of ``frames_per_tile``
threads (``lanes_per_frame`` 1, ``max_frames_per_block`` 256), all S path
metrics in the thread's registers (``H100_REGISTERS["unified_thread"]``),
and the survivors in a ring of ``thread_ring_slots`` stages of
``thread_ring_words`` words a frame in the block's shared memory
(``unified_smem_bytes``' ``survivor_ring``; ``pack_survivors`` changes
nothing there), beside each warp's two LLR chunks (``thread_llr_bytes``).
A tile whose rings do not fit does not fit; where one frame's does not
(no tile fits), B1's wrapper runs the code on the warp mapping and its
device-memory scratch. ``b1_mapping`` names the mapping a code runs on.

Rates below 1/8 (beta > ``MAX_BETA`` = 8) at k <= 11 run the warp mapping
with beta at run time (``low_rate``: acs.cuh's ``VitFrame<R, 0>``, one
instantiation per R): each warp also stages its frames' LLRs a chunk at a
time in shared memory (``llr_chunk_bytes``), and the CPU plans them with
the registers of that form (``H100_REGISTERS``' ``*_lowrate`` counts).

Codes 12 <= k <= 15 (``smem_mapping``) run the cluster mapping's
one-block form (acs.cuh's ``VitCluster`` with no cluster; a butterfly
table a stage at beta <= 8, per-edge sums past it): one frame a block of
``large_threads`` threads with the path metrics in shared memory, so
their only tile is one frame and the block's shared memory counts the
path metrics beside ``BLOCK_CORE_BYTES``. Their launch takes
``block_grid`` blocks, the most that are resident at once
(``block_capacity`` an SM: the card's
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, ``H100_BLOCKS`` on the
CPU), and each block takes frames in turn. B1 keeps a frame's survivors
and traceback starts beside the path metrics where that costs no resident
frame of the launch (``block_survivors_on_chip``), else in a device-memory
scratch per block, so every such code has a plan that fits.

``MAX_K`` = 15 is the edge of those two fast mappings. Every code past it
(``wide_mapping``: k > 15) runs the wide mapping: one frame a block of
``wide_threads`` (S/2 clamped to 32..1024) threads, k and beta at run
time, survivors and path metrics in a device-memory scratch. Its only
tile is one frame and it always fits: a block's shared memory is a fixed
core (``WIDE_CORE_BYTES``). Its launch takes ``wide_grid`` blocks, the
most that are resident at once, and each block takes frames in turn, so
the scratch is per block.

Codes 16 <= k <= 19 run the wide mapping on a thread-block cluster
instead (``wide_cluster``: C = 2^(k-15) blocks a frame, acs.cuh's
``VitCluster``), where the card keeps such a cluster resident: the path
metrics stay in the cluster's shared memory, 8 S / C bytes a block beside
``CLUSTER_CORE_BYTES``, and ``wide_grid`` counts clusters (the card's
``cudaOccupancyMaxActiveClusters``; ``H100_CLUSTERS`` on the CPU). Where
the card holds no cluster of C, ``wide_cluster`` is 1 and the code keeps
the device-memory path.

``plan_decode`` returns the whole plan the decode front end executes:
kernel, layout, tile and chunk geometry (``chunk_frames`` = two tiles per
device, as in the JAX package), optionally measured on the card
(``measure=True``) and cached in the tune DB (kernels/tunedb.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import time

import numpy as np
import torch

from ..core.framed import FrameSpec
from ..core.trellis import Trellis
from ..obs.tracer import get_tracer
from .block import resolve_block
from .packing import Layout, packed_width
from .tunedb import TUNE_DB, TuneDB, platform_id

__all__ = ["TilePlan", "DecodePlan", "DeviceLimits", "H100_LIMITS",
           "H100_REGISTERS", "device_limits", "kernel_registers",
           "unified_smem_bytes", "split_smem_bytes", "candidate_tiles",
           "plan_tiles", "plan_decode", "measure_plan", "AUTO_LAYOUT",
           "BLOCK_THREADS", "lanes_per_frame", "max_frames_per_block",
           "THREAD_MIN_K", "THREAD_MAX_K", "THREAD_MAX_BETA",
           "thread_mapping", "b1_mapping", "thread_ring_slots",
           "thread_ring_words", "THREAD_CHUNK",
           "thread_llr_bytes",
           "block_threads", "SMEM_MIN_K", "MAX_K", "MAX_BETA", "FWD_WIDE_K",
           "smem_mapping", "wide_mapping", "wide_threads", "large_threads",
           "low_rate", "llr_chunk_bytes",
           "BLOCK_CORE_BYTES", "H100_BLOCKS", "block_capacity",
           "block_grid", "block_survivors_on_chip", "tile_survivors_on_chip",
           "wide_grid", "WIDE_CORE_BYTES", "H100_SMS",
           "CLUSTER_MIN_K", "CLUSTER_MAX_K", "CLUSTER_CORE_BYTES",
           "H100_CLUSTERS", "cluster_size", "cluster_threads",
           "cluster_capacity", "wide_cluster"]

#: Most threads one block of either kernel runs (csrc/acs.cuh
#: VIT_BLOCK_THREADS): eight warps.
BLOCK_THREADS = 256
#: Codes from this k on take the cluster mapping's one-block form: one
#: block a frame, path metrics in shared memory (VIT_SMEM_MIN_K).
SMEM_MIN_K = 12
#: The largest code the two fast mappings take (VIT_SMEM_MAX_K); past it
#: the wide mapping runs.
MAX_K = 15
#: B1's thread mapping (viterbi_unified.cu VIT_THREAD_MIN_K, _MAX_K,
#: _MAX_BETA): one thread a frame for THREAD_MIN_K <= k <= THREAD_MAX_K at
#: beta <= THREAD_MAX_BETA.
THREAD_MIN_K = 3
THREAD_MAX_K = 7
THREAD_MAX_BETA = 3
#: Frames an SM from which a launch takes the thread mapping: one
#: thread's serial chain puts a floor of about 0.2 ms under a K=7 launch
#: of the main frame, which the warp mapping beats until the frames fill
#: the card (in turns on an H100: 4.2x faster at 64 frames, 1.9x at
#: 4,096, even at 8,192, 1.8x slower at 16,384; PERF.md §6).
THREAD_MIN_FRAMES_PER_SM = 64
#: The largest beta the register mapping instantiates per beta and the
#: one-block form tabulates (VIT_MAX_BETA); past it both take beta at run
#: time (``low_rate``).
MAX_BETA = 8
#: The code whose forward kernel (B3) runs the wide mapping past beta = 8
#: (csrc/viterbi_fwd.cu VIT_FWD_WIDE_K): there the register form's
#: forward kernel (8 registers a lane) compiles each warp-collective with
#: a divergent slow path and loses to the wide mapping (PERF.md).
FWD_WIDE_K = 9
#: Threads of a one-block frame by k (acs.cuh vit_block_threads): at
#: beta <= 8 the fastest of 128, 256 and 512 at eight frames an SM on an
#: H100 (tools/variant_turns.py --large; PERF.md); past it, where each
#: butterfly sums its own terms, the fastest at one to eight frames an SM
#: (tools/variant_turns.py --low-rate); below k = 12, where only a test
#: forces the form, 128; never more than the S/2 butterflies.
_LARGE_THREADS = {12: 256, 13: 128, 14: 256, 15: 512}
_LOW_RATE_THREADS = {12: 256, 13: 512, 14: 512, 15: 512}
#: Bytes of the one-block form's fixed shared memory (VIT_BLOCK_CORE_BYTES):
#: the cluster core's layout with one block's partials: two stages'
#: butterfly tables (2^8 float4 each), max and argmax partials of 32 warps,
#: two stages each, the word staging, the LLR buffer and the polynomials.
#: The path metrics, 8 S bytes, come after it.
BLOCK_CORE_BYTES = (2 * 256 * 16 + 2 * 2 * 32 * 4 + 2 * 32 * 4 + 2 * 32 * 4
                    + 32 * 4)
#: Bytes of the wide mapping's fixed shared memory (VIT_WIDE_CORE_BYTES):
#: warp partials, a two-stage LLR buffer and the polynomials, 32 terms each.
WIDE_CORE_BYTES = 4 * 4 * 32 + 2 * 4 * 32 + 4 * 32
#: Most threads of a wide-mapping block (VIT_WIDE_MAX_THREADS) and of a
#: cluster block (VIT_CLUSTER_THREADS).
_WIDE_MAX_THREADS = 1024
_CLUSTER_THREADS = 512
#: Streaming multiprocessors of an H100 SXM, what the CPU plans with.
H100_SMS = 132
#: Codes from CLUSTER_MIN_K to CLUSTER_MAX_K run the wide mapping on a
#: cluster of 2^(k-15) blocks (acs.cuh VIT_CLUSTER_MIN_K, _MAX_K).
CLUSTER_MIN_K = 16
CLUSTER_MAX_K = 19
#: Bytes of a cluster block's fixed shared memory (VIT_CLUSTER_CORE_BYTES):
#: two stages' butterfly tables (2^8 float4 each); max and argmax partials
#: for 16 blocks (the H100's largest cluster) of 32 warps, two stages
#: each; the small-code word staging; the LLR buffer and the polynomials.
#: The path metrics, 8 S / C bytes, come after it.
CLUSTER_CORE_BYTES = (2 * 256 * 16 + 2 * 2 * 16 * 32 * 4 + 2 * 32 * 4
                      + 2 * 32 * 4 + 32 * 4)
_BM_DTYPES = ("float32", "bfloat16")


def wide_mapping(trellis: Trellis, unified: bool = True) -> bool:
    """Whether B1 (or, with ``unified=False``, B3) runs ``trellis`` on the
    wide mapping: any code past the fast mappings' ``MAX_K``, at any beta
    (acs.cuh vit_wide_code); for B3 also ``FWD_WIDE_K`` past beta = 8
    (viterbi_fwd.cu fwd_wide_code)."""
    return trellis.k > MAX_K or (not unified and trellis.k == FWD_WIDE_K
                                 and low_rate(trellis))


def smem_mapping(trellis: Trellis) -> bool:
    """Whether the kernels run ``trellis`` on the cluster mapping's
    one-block form (12 <= k <= 15, any beta)."""
    return trellis.k >= SMEM_MIN_K and not wide_mapping(trellis)


def low_rate(trellis: Trellis) -> bool:
    """Whether a fast mapping runs ``trellis`` with beta at run time
    (beta > ``MAX_BETA``): the register mapping's ``VitFrame<R, 0>`` or
    the one-block form's per-edge sums."""
    return trellis.beta > MAX_BETA


def llr_chunk_bytes(trellis: Trellis) -> int:
    """Shared memory of one warp's LLR chunks in the register mapping at
    a run-time beta (acs.cuh vit_llr_chunk_bytes): two chunks of 32 stage
    rows of beta float32 rounded up to whole float4; 0 at beta <= 8."""
    if not low_rate(trellis):
        return 0
    return 2 * 32 * (-(-trellis.beta // 4) * 4) * 4


def wide_threads(trellis: Trellis) -> int:
    """Threads of one wide-mapping block: one a butterfly (S/2), at
    least a warp, at most 1024 (acs.cuh vit_wide_threads)."""
    return max(32, min(_WIDE_MAX_THREADS, trellis.num_states // 2))


def cluster_size(trellis: Trellis) -> int:
    """The cluster the mapping puts a code on: C = 2^(k-15) blocks for
    CLUSTER_MIN_K <= k <= CLUSTER_MAX_K (each block's double-buffered path
    metrics 128 KB), else 1 (acs.cuh vit_cluster_size)."""
    k = trellis.k
    return 1 << (k - 15) if CLUSTER_MIN_K <= k <= CLUSTER_MAX_K else 1


def cluster_threads(trellis: Trellis, cluster: int) -> int:
    """Threads of one block of a cluster of ``cluster`` blocks: one a
    butterfly of the block's S / 2 / C, at least a warp, at most
    ``_CLUSTER_THREADS`` (acs.cuh vit_cluster_threads)."""
    return max(32, min(_CLUSTER_THREADS,
                       trellis.num_states // 2 // int(cluster)))


def large_threads(trellis: Trellis) -> int:
    """Threads of a one-block frame (acs.cuh vit_block_threads): 256, 128,
    256 and 512 at k = 12..15 (4, 16, 16, 16 butterflies a thread) at
    beta <= 8, 256, 512, 512, 512 (4, 4, 8, 16) past it, 128 below
    k = 12, at most S/2."""
    table = _LOW_RATE_THREADS if low_rate(trellis) else _LARGE_THREADS
    return min(trellis.num_states // 2, table.get(trellis.k, 128))


def thread_mapping(trellis: Trellis, unified: bool = True,
                   frames: int | None = None, device=None) -> bool:
    """Whether B1 runs ``trellis`` on the thread mapping (one thread a
    frame, all its path metrics in the thread's registers): THREAD_MIN_K
    <= k <= THREAD_MAX_K at beta <= THREAD_MAX_BETA (viterbi_unified.cu
    vit_thread_code), and, given a launch's ``frames``, where they fill
    the card: THREAD_MIN_FRAMES_PER_SM an SM of ``device``'s, the frames
    counted in whole blocks of the warp mapping, so that the planner
    (before the padding to its tile) and B1's wrapper (after it) agree.
    B3 (``unified=False``) never does."""
    if not (unified and THREAD_MIN_K <= trellis.k <= THREAD_MAX_K
            and 2 <= trellis.beta <= THREAD_MAX_BETA):
        return False
    if frames is None:
        return True
    cap = max_frames_per_block(trellis, warp=True)
    return (-(-int(frames) // cap) * cap
            >= THREAD_MIN_FRAMES_PER_SM * _sm_count(device))


_sm_counts: dict = {}


def _sm_count(device=None) -> int:
    """The card's SMs, queried once per device; ``H100_SMS`` for the
    CPU."""
    dev = _resolve_device(device)
    if dev.type != "cuda":
        return H100_SMS
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def b1_mapping(trellis: Trellis, unified: bool = True,
               frames: int | None = None, device=None) -> str:
    """The mapping B1 (or, with ``unified=False``, B3) runs ``trellis``
    on, by k and beta and a launch's ``frames`` (``thread_mapping``):
    "thread", "warp" (the register mapping), "block" (the one-block form,
    12 <= k <= 15), "cluster" or "wide" (past k = 15, on a cluster where
    the card holds one)."""
    if thread_mapping(trellis, unified, frames, device):
        return "thread"
    if wide_mapping(trellis, unified):
        return "cluster" if cluster_size(trellis) > 1 else "wide"
    return "block" if smem_mapping(trellis) else "warp"


def thread_ring_slots(f0: int, v2s: int) -> int:
    """Stages of the thread mapping's survivor ring: a traceback start's
    f0 + v2s (vit_thread_slots)."""
    return int(f0) + int(v2s)


#: Stages of one LLR chunk the thread mapping stages in shared memory
#: (VIT_THREAD_CHUNK).
THREAD_CHUNK = 8


def thread_llr_bytes(trellis: Trellis, frames_per_tile: int) -> int:
    """Shared memory of a thread-mapping block's LLR chunks: two a warp,
    each 32 rows of ``THREAD_CHUNK`` stages as float32 plus two words
    (vit_thread_chunk_words)."""
    warps = -(-int(frames_per_tile) // 32)
    return warps * 2 * 32 * (THREAD_CHUNK * trellis.beta + 2) * 4


def thread_ring_words(trellis: Trellis) -> int:
    """32-bit survivor words a stage of the thread mapping: one per 32
    states (vit_thread_words)."""
    return packed_width(trellis.num_states)


def lanes_per_frame(trellis: Trellis, unified: bool = True,
                    warp: bool = False) -> int:
    """Lanes of a warp one frame's path metrics take: one on B1's thread
    mapping, else ``min(S, 32)`` (a large code's frame takes a whole
    block of such warps). ``warp``: on the warp mapping, wherever B1
    runs the code there."""
    if thread_mapping(trellis, unified and not warp):
        return 1
    return min(trellis.num_states, 32)


def max_frames_per_block(trellis: Trellis, unified: bool = True,
                         warp: bool = False) -> int:
    """The thread cap: eight warps of ``32 // lanes_per_frame`` frames;
    one frame for a large or wide code (of B3 with ``unified=False``).
    ``warp``: the register (warp) mapping's cap."""
    if smem_mapping(trellis) or wide_mapping(trellis, unified):
        return 1
    return BLOCK_THREADS // 32 * (32 // lanes_per_frame(
        trellis, unified and not warp))


def block_threads(trellis: Trellis, frames_per_block: int,
                  cluster: int = 1, unified: bool = True,
                  warp: bool = False) -> int:
    """Threads of a block of that many frames: whole warps (one thread a
    frame on the thread mapping; ``warp``: on the warp mapping); a large
    code's block is ``large_threads``, a wide code's (of B3 with
    ``unified=False``) ``wide_threads``, or ``cluster_threads`` in a
    cluster of ``cluster`` > 1 blocks."""
    if wide_mapping(trellis, unified):
        return (cluster_threads(trellis, cluster) if cluster > 1
                else wide_threads(trellis))
    if smem_mapping(trellis):
        return large_threads(trellis)
    if thread_mapping(trellis, unified and not warp):
        return int(frames_per_block)
    fpw = 32 // lanes_per_frame(trellis, unified, warp)
    return -(-int(frames_per_block) // fpw) * 32


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What the planner models of one card (CUDA device attributes)."""
    smem_per_block: int            # opt-in dynamic shared memory per block
    smem_per_sm: int
    threads_per_sm: int
    blocks_per_sm: int
    smem_reserved_per_block: int   # the runtime's own share of each block
    regs_per_sm: int               # 32-bit registers


#: NVIDIA H100 (compute capability 9.0), CUDA C++ Programming Guide table
#: of compute capabilities: 227 KB opt-in per block, 228 KB per SM, 2048
#: threads and 32 blocks per SM, 1 KB reserved per block, 64 K registers
#: per SM. What the CPU plans with.
H100_LIMITS = DeviceLimits(232448, 233472, 2048, 32, 1024, 65536)

#: Registers per thread of each kernel's instantiation at the main path's
#: code (K=7, beta=2): ``numRegs`` as ``cudaFuncGetAttributes`` reported it
#: on an NVIDIA H100 80GB HBM3 (chip_smoke.py's build phase prints every
#: instantiation's). The CPU plans every code with it; on the card the
#: planner asks the kernels, whose counts grow with R and beta. The
#: ``*_lowrate`` counts are the register mapping's at a run-time beta (K=7
#: beta=9), which the CPU reports for every code past beta = 8 at
#: k <= 11. The ``*_block`` counts are the one-block form's at k = 12
#: (its registers do not depend on beta <= 8; ``*_block_lowrate``: k = 12
#: beta = 9, the per-edge sums), which the CPU reports for the codes
#: 12 <= k <= 15 (their resident blocks are ``H100_BLOCKS``); the
#: ``*_wide`` counts the wide mapping's (one instantiation for every code
#: past them); the ``*_cluster`` counts its cluster kernels' at k = 16
#: beta = 2 (512 threads a block, so at most 128 registers a thread);
#: ``unified_thread`` B1's thread mapping's at K=7 beta=2, which the CPU
#: reports for every code of that mapping (``unified`` stays the warp
#: mapping's, which B1 runs K=7 on only where a test forces it).
H100_REGISTERS = {"unified": 48, "unified_thread": 133, "split": 48,
                  "unified_lowrate": 64,
                  "split_lowrate": 64, "unified_block": 64,
                  "split_block": 64, "unified_block_lowrate": 64,
                  "split_block_lowrate": 64, "unified_wide": 64,
                  "split_wide": 62, "unified_cluster": 128,
                  "split_cluster": 128}

#: Blocks of the one-block kernels (k = 12..15, ``large_threads`` threads,
#: the recursion's shared memory alone: the forward kernel's block, and
#: B1's with its survivors in the scratch) an NVIDIA H100 80GB HBM3 keeps
#: resident on one SM: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on
#: the card (chip_smoke.py's build phase prints it); ``*_lowrate``: the
#: per-edge sums' kernels past beta = 8. What the CPU plans with; a block
#: with more shared memory holds no more than the SM's shared memory
#: allows beside it.
H100_BLOCKS = {"unified": {12: 4, 13: 4, 14: 2, 15: 1},
               "split": {12: 4, 13: 4, 14: 2, 15: 1},
               "unified_lowrate": {12: 4, 13: 2, 14: 1, 15: 1},
               "split_lowrate": {12: 4, 13: 2, 14: 1, 15: 1}}

#: Clusters of C blocks of the cluster kernels (one 1024-thread block of
#: 2^14 states an SM, k = 15 + log2 C) an NVIDIA H100 80GB HBM3 keeps
#: resident at once: ``cudaOccupancyMaxActiveClusters`` on the card
#: (chip_smoke.py's time phase prints it). What the CPU plans with.
H100_CLUSTERS = {2: 66, 4: 30, 8: 15, 16: 7}

_limits: dict = {}


def _resolve_device(device) -> torch.device:
    from .ops import resolve_device           # ops imports this module
    return resolve_device(device)


def device_limits(device=None) -> DeviceLimits:
    """The card's limits (``device=None`` = ``"cuda"``; raises without a
    card), queried once per device; ``H100_LIMITS`` for the CPU."""
    dev = _resolve_device(device)
    if dev.type != "cuda":
        return H100_LIMITS
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _limits:
        from .viterbi_unified import kernel_library
        out = (ctypes.c_int * 6)()
        err = kernel_library().lib.viterbi_device_limits(index, out)
        if err != 0:
            raise RuntimeError(f"cannot query cuda:{index}: CUDA error {err}")
        _limits[index] = DeviceLimits(*out)
    return _limits[index]


_registers: dict = {}


def _library(unified: bool):
    if unified:
        from .viterbi_unified import kernel_library
    else:
        from .viterbi_fwd import kernel_library
    return kernel_library().lib


def kernel_registers(trellis: Trellis, *, unified: bool = True,
                     device=None, cluster: int | None = None,
                     wide: bool = False, warp: bool = False) -> int:
    """Registers per thread of the kernel instantiation that runs
    ``trellis`` (``device=None`` = ``"cuda"``: asked of the built kernel
    through ``cudaFuncGetAttributes``; the CPU takes ``H100_REGISTERS``,
    the main path's count, for every code of its mapping). ``cluster``
    (default ``wide_cluster``'s) > 1 asks for the cluster kernel's;
    ``wide`` for the wide kernel's off a cluster, whatever the code (a
    forced launch); ``warp`` for the warp mapping's, at a code of the
    thread mapping."""
    name = "unified" if unified else "split"
    dev = _resolve_device(device)
    if cluster is None:
        cluster = (wide_cluster(trellis, dev, unified=unified)
                   if wide_mapping(trellis, unified) else 1)
    wide = cluster <= 1 and (wide or wide_mapping(trellis, unified))
    thread = (not wide and cluster <= 1
              and thread_mapping(trellis, unified and not warp))
    if dev.type != "cuda":
        if cluster > 1:
            return H100_REGISTERS[name + "_cluster"]
        if wide:
            return H100_REGISTERS[name + "_wide"]
        if thread:
            return H100_REGISTERS["unified_thread"]
        return H100_REGISTERS[name + ("_block" if smem_mapping(trellis)
                                      else "")
                              + ("_lowrate" if low_rate(trellis) else "")]
    # the wide kernel is one instantiation, which any k >= 16 code asks for
    k, beta = (max(trellis.k, 20), trellis.beta) if wide else \
        (trellis.k, trellis.beta)
    key = (name, k, beta, int(cluster), thread)
    if key not in _registers:
        out = (ctypes.c_int * 3)()
        if thread:
            fn = "viterbi_unified_thread_attrs"
            err = _library(True).viterbi_unified_thread_attrs(k, beta, out)
        elif cluster > 1:
            fn = f"viterbi_{'unified' if unified else 'fwd'}_cluster_attrs"
            err = getattr(_library(unified), fn)(k, beta, int(cluster), out)
        else:
            fn = f"viterbi_{'unified' if unified else 'fwd'}_func_attrs"
            err = getattr(_library(unified), fn)(k, beta, out)
        if err != 0:
            raise RuntimeError(f"{fn}(k={k}, beta={beta}, cluster={cluster})"
                               f": CUDA error {err}")
        _registers[key] = int(out[0])
    return _registers[key]


_blocks: dict = {}


def block_capacity(trellis: Trellis, device=None, *, unified: bool = True,
                   smem: int | None = None) -> int:
    """Blocks of the one-block kernel that runs ``trellis`` the card keeps
    resident on one SM, each with ``smem`` bytes of shared memory (default
    the recursion's alone, ``_large_smem``: the forward kernel's block,
    and B1's with its survivors in the scratch). ``device=None`` =
    ``"cuda"``: the card's ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    queried once; the CPU takes ``H100_BLOCKS``, less where the SM's shared
    memory holds fewer blocks of ``smem``."""
    dev = _resolve_device(device)
    core = _large_smem(trellis)[0]
    smem = core if smem is None else int(smem)
    if dev.type != "cuda":
        lim = H100_LIMITS
        name = (("unified" if unified else "split")
                + ("_lowrate" if low_rate(trellis) else ""))
        return min(H100_BLOCKS[name][trellis.k],
                   lim.smem_per_sm // (smem + lim.smem_reserved_per_block))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (unified, trellis.k, low_rate(trellis), smem, index)
    if key not in _blocks:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            if unified:
                err = _library(True).viterbi_unified_block_occupancy(
                    trellis.k, trellis.beta, smem, ctypes.byref(out))
            elif smem != core:
                raise ValueError(f"the forward kernel's block has {core} "
                                 f"bytes, not {smem}")
            else:
                err = _library(False).viterbi_fwd_block_occupancy(
                    trellis.k, trellis.beta, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"block occupancy (k={trellis.k}, smem="
                               f"{smem}): CUDA error {err}")
        _blocks[key] = int(out.value)
    return _blocks[key]


def block_grid(trellis: Trellis, frames: int, device=None, *,
               unified: bool = True, smem: int | None = None) -> int:
    """Blocks of a one-block launch over ``frames`` frames: at most one a
    frame and at most as many as the card keeps resident at once (its SMs
    times ``block_capacity``), each taking frames in turn. Raises where
    the card holds none."""
    dev = _resolve_device(device)
    cap = block_capacity(trellis, dev, unified=unified, smem=smem)
    if cap < 1:
        raise RuntimeError(f"the card keeps no block of k={trellis.k} "
                           f"({smem} B of shared memory) resident")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    return max(1, min(int(frames), sms * cap))


def block_survivors_on_chip(trellis: Trellis, spec: FrameSpec, *,
                            pack_survivors: bool,
                            frames: int | None = None, device=None,
                            budget: int | None = None) -> bool:
    """Whether B1's one-block kernel keeps a frame's survivors and starts
    in shared memory beside the path metrics (else in a device-memory
    scratch per block): where they fit in a block (``budget``, default the
    card's limit) and the blocks that hold them keep as many of the
    launch's ``frames`` (default: as many as the card holds) resident at
    once as the blocks without them."""
    dev = _resolve_device(device)
    on, _ = unified_smem_bytes(trellis, spec, 1,
                               pack_survivors=pack_survivors)
    if not smem_mapping(trellis):    # a code a test forces on the form
        on += _large_smem(trellis)[0]
    if on > (device_limits(dev).smem_per_block if budget is None
             else int(budget)):
        return False
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    want = sms * block_capacity(trellis, dev)
    if frames is not None:
        want = min(want, int(frames))
    return sms * block_capacity(trellis, dev, smem=on) >= want


_tile_residency: dict = {}


def tile_survivors_on_chip(trellis: Trellis, spec: FrameSpec,
                           frames_per_tile: int, *, pack_survivors: bool,
                           frames: int | None = None, device=None,
                           budget: int | None = None) -> bool:
    """Whether B1's register mapping past beta = 8 (``low_rate``; the
    planner and B1's wrapper ask only there) keeps a block's survivors and
    starts in shared memory (else in a device-memory scratch per frame):
    where a block of ``frames_per_tile`` frames holds them (``budget``,
    default the card's limit) and the blocks that hold them keep as many
    of the launch's ``frames`` (default: as many as the card holds)
    resident at once as the blocks without them, ``block_survivors_on_chip``'s
    rule: at K=11 rate 1/9 a packed frame's survivors (41 KB) leave 5
    frames an SM where its registers leave 32. (At beta <= 8 they stay on
    chip wherever they fit: the tile planner weighs their bytes.) The
    resident frames are cached by everything but ``frames``."""
    dev = _resolve_device(device)
    fpb = int(frames_per_tile)
    key = (trellis.k, trellis.beta, spec, fpb, bool(pack_survivors),
           str(dev), budget)
    if key not in _tile_residency:
        limits = device_limits(dev)
        on, _ = unified_smem_bytes(trellis, spec, fpb,
                                   pack_survivors=pack_survivors)
        off, _ = unified_smem_bytes(trellis, spec, fpb,
                                    pack_survivors=pack_survivors,
                                    scratch=True)
        threads = block_threads(trellis, fpb)
        regs = kernel_registers(trellis, unified=True, device=dev,
                                cluster=1)
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev.type == "cuda" else H100_SMS)
        fits = on <= (limits.smem_per_block if budget is None
                      else int(budget))
        _tile_residency[key] = (
            sms * _resident_frames(on, threads, fpb, regs, limits)
            if fits else -1,
            sms * _resident_frames(off, threads, fpb, regs, limits))
    on, off = _tile_residency[key]
    return on >= (off if frames is None else min(off, int(frames)))


_clusters: dict = {}


def cluster_capacity(trellis: Trellis, cluster: int, device=None, *,
                     unified: bool = True) -> int:
    """Clusters of ``cluster`` blocks of the kernel that runs ``trellis``
    the card keeps resident at once (``device=None`` = ``"cuda"``: the
    card's ``cudaOccupancyMaxActiveClusters``, queried once; the CPU takes
    ``H100_CLUSTERS``). Raises where the card refuses the query."""
    dev = _resolve_device(device)
    C = int(cluster)
    if dev.type != "cuda":
        return H100_CLUSTERS.get(C, 0)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (unified, trellis.k, trellis.beta, C, index)
    if key not in _clusters:
        fn = f"viterbi_{'unified' if unified else 'fwd'}_max_clusters"
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = getattr(_library(unified), fn)(trellis.k, trellis.beta, C,
                                                 ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{fn}(k={trellis.k}, beta={trellis.beta}, "
                               f"C={C}): the card refuses a cluster of {C} "
                               f"blocks (CUDA error {err})")
        _clusters[key] = int(out.value)
    return _clusters[key]


def wide_cluster(trellis: Trellis, device=None, *,
                 unified: bool = True) -> int:
    """Blocks of the cluster one frame of ``trellis`` runs on:
    ``cluster_size`` (2, 4, 8, 16 at k = 16-19) where the card keeps at
    least one such cluster resident, else 1 (no cluster: the device-memory
    path of the wide mapping, or another mapping)."""
    C = cluster_size(trellis)
    if C > 1 and cluster_capacity(trellis, C, device, unified=unified) < 1:
        return 1
    return C


def wide_grid(trellis: Trellis, frames: int, device=None, *,
              unified: bool = True, cluster: int | None = None) -> int:
    """Blocks of a wide-mapping launch over ``frames`` frames: at most
    one a frame, and at most as many as the card keeps resident at once
    (its SMs times the blocks an SM holds by threads, block slots, shared
    memory and the kernel's registers), so that no block waits for
    another and the per-block scratch is no larger than it must be. On a
    cluster (``cluster``, default ``wide_cluster``'s, > 1) it counts
    clusters, at most one a frame and at most ``cluster_capacity``; raises
    where the card holds none."""
    dev = _resolve_device(device)
    C = (wide_cluster(trellis, dev, unified=unified) if cluster is None
         else int(cluster))
    if C > 1:
        cap = cluster_capacity(trellis, C, dev, unified=unified)
        if cap < 1:
            raise RuntimeError(f"the card keeps no cluster of {C} blocks "
                               f"resident for k={trellis.k}")
        return max(1, min(int(frames), cap))
    limits = device_limits(dev)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    per_sm = _resident_frames(
        _wide_smem(trellis, 1)[0], wide_threads(trellis), 1,
        kernel_registers(trellis, unified=unified, device=dev, cluster=1,
                         wide=True),
        limits)
    return max(1, min(int(frames), sms * max(1, per_sm)))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Chosen tile and the footprint that justified it."""
    frames_per_tile: int
    smem_bytes: int           # dynamic shared memory of one block
    breakdown: tuple          # ((name, bytes), ...) for reports/debugging
    budget: int
    kernel: str = "unified"   # 'unified' | 'split'
    layout: Layout = Layout.LANE
    bm_dtype: str = "float32"
    #: The JAX plan's padded-VMEM flag, a TPU notion: always False here.
    #: Kept so the two packages' plans have the same fields.
    mosaic: bool = False
    frames_per_sm: int = 0    # resident frames per SM (0: does not fit)
    registers: int = 0        # per thread, of the kernel instantiation

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= self.budget

    def utilization(self) -> float:
        return self.smem_bytes / self.budget

    def cache_key(self) -> tuple:
        """The knobs that select a distinct kernel launch; the JAX
        package's tuple. Footprint bookkeeping is excluded: two plans that
        picked the same knobs launch the same kernel."""
        return (self.kernel, int(self.frames_per_tile),
                Layout(self.layout).value, str(self.bm_dtype))


def _geometry(spec: FrameSpec):
    """(f0, v2s) as the kernel sees them (serial tb = one full subframe)."""
    if spec.parallel_tb:
        return spec.f0, spec.v2s
    return spec.f, spec.v2


def _check_knobs(layout, bm_dtype):
    Layout(layout)
    if str(bm_dtype) not in _BM_DTYPES:
        raise ValueError(f"bm_dtype must be one of {list(_BM_DTYPES)}, got "
                         f"{bm_dtype!r}")


def unified_smem_bytes(trellis: Trellis, spec: FrameSpec,
                       frames_per_tile: int, *, pack_survivors: bool = False,
                       radix: int = 2, layout=Layout.LANE,
                       bm_dtype: str = "float32", scratch: bool = False,
                       cluster: int = 1, warp: bool = False):
    """(total_bytes, breakdown) of one unified-kernel block: the carve-up of
    ``csrc/viterbi_unified.cu::smem_layout``. Each frame keeps its
    traceback starts (one int32 state per subframe, the block's padded to
    16 bytes; none for ``start='fixed'``) and its survivors, one bit per
    state packed
    (``4 * ceil(S/32)`` bytes a stage) or one byte. Path metrics and branch
    metrics live in registers, so ``bm_dtype`` and ``radix`` change
    nothing, and the layout is not a shared-memory orientation on Hopper;
    they are accepted so call sites can pass the whole configuration. Past
    beta = 8 each warp also keeps its LLR chunks (``llr_chunk_bytes``)
    ahead of the starts.

    A large code (``smem_mapping``: one frame a block) keeps its path
    metrics in two shared buffers of S float32 beside the one-block form's
    tables and partials (``smem_layout_block``).
    ``scratch=True`` is the kernel's device-memory survivor scratch:
    survivors and traceback starts leave shared memory.

    A code of the thread mapping (``thread_mapping``) keeps its survivor
    ring and each warp's LLR chunks; it has no scratch, so ``scratch=True``
    there is the warp mapping's block, which B1 runs such a code on where
    one frame's ring does not fit, as it does where the launch's frames
    do not fill the card (``warp``).

    A wide code (``wide_mapping``) keeps its survivors and starts in the
    scratch always: its block is the mapping's fixed core and, to k = 15,
    the path metrics (``spec`` is not read); in a cluster of ``cluster``
    > 1 blocks (``plan_tiles`` passes ``wide_cluster``'s) the cluster core
    and the block's 8 S / C bytes of path metrics."""
    _check_knobs(layout, bm_dtype)
    del radix
    if wide_mapping(trellis):
        return _wide_smem(trellis, cluster)
    if thread_mapping(trellis) and not (scratch or warp):
        f0, v2s = _geometry(spec)
        ring = (4 * thread_ring_slots(f0, v2s) * thread_ring_words(trellis)
                * int(frames_per_tile))
        breakdown = (("survivor_ring", -(-ring // 16) * 16),
                     ("llr_chunks", thread_llr_bytes(trellis,
                                                     frames_per_tile)))
        return sum(b for _, b in breakdown), breakdown
    S = trellis.num_states
    W = packed_width(S)
    fpb = int(frames_per_tile)
    f0, _ = _geometry(spec)
    nsub = spec.f // f0
    fixed = spec.parallel_tb and spec.start == "fixed"
    row = 4 * W if pack_survivors else S
    if smem_mapping(trellis):
        core = _large_smem(trellis)[1]
    elif low_rate(trellis):
        core = (("llr_chunks", block_threads(trellis, fpb) // 32
                 * llr_chunk_bytes(trellis)),)
    else:
        core = ()
    breakdown = core + (
        ("traceback_starts",
         0 if fixed or scratch else -(-fpb * nsub * 4 // 16) * 16),
        ("sel_survivors", 0 if scratch else fpb * spec.frame_len * row))
    return sum(b for _, b in breakdown), breakdown


def _large_smem(trellis: Trellis):
    """(total_bytes, breakdown) of the one-block form's recursion: its
    path metrics and core (acs.cuh vit_block_smem_bytes)."""
    breakdown = (("path_metrics", 8 * trellis.num_states),
                 ("tables_and_partials", BLOCK_CORE_BYTES))
    return sum(b for _, b in breakdown), breakdown


def _wide_smem(trellis: Trellis, cluster: int = 1):
    """(total_bytes, breakdown) of one wide-mapping block of either
    kernel (acs.cuh VIT_WIDE_CORE_BYTES), or, with ``cluster`` > 1, of
    one block of a cluster of that many (vit_cluster_smem_bytes)."""
    C = int(cluster)
    if C > 1:
        pm, core = 8 * trellis.num_states // C, CLUSTER_CORE_BYTES
    else:
        pm, core = 0, WIDE_CORE_BYTES
    breakdown = (("path_metrics", pm), ("tables_and_partials", core),
                 ("traceback_starts", 0), ("sel_survivors", 0))
    return sum(b for _, b in breakdown), breakdown


def split_smem_bytes(trellis: Trellis, spec: FrameSpec,
                     frames_per_tile: int, *, pack_survivors: bool = False,
                     radix: int = 2, layout=Layout.LANE,
                     bm_dtype: str = "float32", cluster: int = 1):
    """(total_bytes, breakdown) of one forward-kernel block: the carve-up
    of ``csrc/viterbi_fwd.cu::fwd_smem``. Its path metrics live in
    registers and its survivors and argmax go to device memory; each warp
    stages one run of them (32 words and 32 argmax, 256 bytes) in shared
    memory, whatever the knobs, and past beta = 8 its LLR chunks
    (``llr_chunk_bytes``). A large code's block keeps the one-block
    form's path metrics, tables and partials instead, a wide code's the
    wide mapping's (on a cluster of ``cluster`` blocks, as
    ``unified_smem_bytes``)."""
    _check_knobs(layout, bm_dtype)
    del spec, pack_survivors, radix
    if wide_mapping(trellis, unified=False):
        return _wide_smem(trellis, cluster)
    if smem_mapping(trellis):
        return _large_smem(trellis)
    warps = block_threads(trellis, frames_per_tile, unified=False) // 32
    breakdown = (("run_buffers", warps * 256),) + (
        (("llr_chunks", warps * llr_chunk_bytes(trellis)),)
        if low_rate(trellis) else ())
    return sum(b for _, b in breakdown), breakdown


def candidate_tiles(trellis: Trellis, max_frames: int | None = None,
                    unified: bool = True, warp: bool = False):
    """Powers of two from 1 up to the thread cap
    ``max_frames_per_block`` (of B1, or of B3 with ``unified=False``;
    ``warp``: of B1's warp mapping), and up to the smallest one that
    covers ``max_frames``."""
    cap = max_frames_per_block(trellis, unified, warp)
    tiles = [1 << i for i in range(cap.bit_length()) if 1 << i <= cap]
    if max_frames is not None:
        cover = next((t for t in tiles if t >= max_frames), tiles[-1])
        tiles = [t for t in tiles if t <= cover]
    return tiles


def _resident_frames(smem: int, threads: int, fpb: int, registers: int,
                     limits: DeviceLimits) -> int:
    """Frames resident on one SM: blocks limited by threads, block slots,
    shared memory (with the runtime's reserve) and registers (allocated
    per warp in units of 256)."""
    regs_per_warp = -(-registers * 32 // 256) * 256
    warps = -(-threads // 32)
    blocks = min(limits.threads_per_sm // (warps * 32), limits.blocks_per_sm,
                 limits.smem_per_sm // (smem + limits.smem_reserved_per_block),
                 limits.regs_per_sm // regs_per_warp // warps)
    return blocks * fpb


def _tile_at(trellis: Trellis, spec: FrameSpec, ft: int, *, unified: bool,
             pack_survivors: bool, radix: int, layout, bm_dtype: str,
             budget: int, limits: DeviceLimits, registers: int,
             cluster: int = 1, device=None,
             frames: int | None = None, warp: bool = False) -> TilePlan:
    """The TilePlan of one tile under the kernel's footprint model
    (``warp``: B1's warp mapping at a code of the thread mapping). A
    large code's block is planned as the kernel runs it: B1's survivors
    in shared memory or the device-memory scratch by
    ``block_survivors_on_chip`` (for ``frames`` frames), its resident
    blocks ``block_capacity``'s; on the register mapping past beta = 8 by
    ``tile_survivors_on_chip``. A wide code's block is one of a cluster
    of ``cluster`` blocks (1: off a cluster): its bytes and its threads
    both."""
    model = unified_smem_bytes if unified else split_smem_bytes
    kw = dict(pack_survivors=pack_survivors, radix=radix, layout=layout,
              bm_dtype=bm_dtype)
    if smem_mapping(trellis):
        if unified:
            total, breakdown = unified_smem_bytes(
                trellis, spec, ft, **kw, scratch=not block_survivors_on_chip(
                    trellis, spec, pack_survivors=pack_survivors,
                    frames=frames, device=device, budget=budget))
        else:
            total, breakdown = split_smem_bytes(trellis, spec, ft, **kw)
        resident = (block_capacity(trellis, device, unified=unified,
                                   smem=total) if total <= budget else 0)
        return TilePlan(int(ft), total, breakdown, budget,
                        "unified" if unified else "split", Layout(layout),
                        str(bm_dtype), False, resident, int(registers))
    if unified and low_rate(trellis) and not wide_mapping(trellis):
        kw["scratch"] = not tile_survivors_on_chip(
            trellis, spec, ft, pack_survivors=pack_survivors, frames=frames,
            device=device, budget=budget)
    if warp:
        kw["warp"] = True
    total, breakdown = model(trellis, spec, ft, **kw, cluster=cluster)
    threads = block_threads(trellis, ft, cluster, unified, warp)
    resident = (_resident_frames(total, threads, ft, registers, limits)
                if total <= budget else 0)
    return TilePlan(int(ft), total, breakdown, budget,
                    "unified" if unified else "split", Layout(layout),
                    str(bm_dtype), False, resident, int(registers))


def plan_tiles(trellis: Trellis, spec: FrameSpec, *,
               pack_survivors: bool = False, radix: int = 2,
               smem_budget: int | None = None,
               max_frames: int | None = None, unified: bool = True,
               layout=Layout.LANE, bm_dtype: str = "float32",
               device=None) -> TilePlan:
    """Pick frames_per_tile for one kernel configuration.

    Among the candidate tiles (``candidate_tiles``) whose block fits
    ``smem_budget`` (default: the device's opt-in per-block limit), the
    one with the most resident frames per SM, and among those the
    smallest; the smallest candidate when none fits. ``max_frames`` caps
    the tile near the frame count. ``unified=False`` budgets the forward
    kernel of the split path. ``device=None`` is ``"cuda"`` (its limits
    are queried; raises without a card); the CPU plans for the H100. A
    code of B1's thread mapping is planned on the warp mapping where
    ``max_frames`` do not fill the card (``thread_mapping``). The search
    runs once per shape and card (``_best_tile``)."""
    spec.validate()
    _check_knobs(layout, bm_dtype)
    dev = _resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    limits = device_limits(dev)
    cluster = (wide_cluster(trellis, dev, unified=unified)
               if wide_mapping(trellis, unified) else 1)
    warp = (thread_mapping(trellis, unified) and not thread_mapping(
        trellis, unified, max_frames, dev))
    registers = kernel_registers(trellis, unified=unified, device=dev,
                                 cluster=cluster, warp=warp)
    budget = limits.smem_per_block if smem_budget is None else int(smem_budget)
    return _best_tile(trellis, spec, bool(pack_survivors), int(radix),
                      Layout(layout), str(bm_dtype), budget, limits,
                      registers, cluster, dev, max_frames, bool(unified),
                      warp)


@functools.lru_cache(maxsize=1024)
def _best_tile(trellis, spec, pack_survivors, radix, layout, bm_dtype,
               budget, limits, registers, cluster, device, max_frames,
               unified, warp) -> TilePlan:
    """``plan_tiles``' search over the candidate tiles, cached by every
    input its footprint and residency models read (the card's limits and
    the kernel's registers among them)."""
    best = None
    for ft in candidate_tiles(trellis, max_frames, unified, warp):
        plan = _tile_at(trellis, spec, ft, unified=unified,
                        pack_survivors=pack_survivors, radix=radix,
                        layout=layout, bm_dtype=bm_dtype, budget=budget,
                        limits=limits, registers=registers, cluster=cluster,
                        device=device, frames=max_frames, warp=warp)
        if best is None or plan.frames_per_sm > best.frames_per_sm:
            best = plan
        if not plan.fits:                    # footprints grow with the tile
            break
    return best


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The full configuration the decode front end executes: kernel knobs
    (tile) plus the streaming geometry (chunk sizing across devices).
    ``block_frames``/``overlap`` are the intra-frame block-parallel knobs
    (kernels/block.py), always stored resolved (1/0 = blocking off); when
    on, ``tile`` is planned for the derived per-block spec and
    ``frames_per_tile`` counts blocks."""
    tile: TilePlan
    pack_survivors: bool
    radix: int
    chunk_frames: int         # frames the stream front end batches per chunk
    num_devices: int          # chunk_frames is a multiple of tiles x devices
    block_frames: int = 1     # intra-frame blocks per frame (1 = off)
    overlap: int = 0          # per-block training/truncation stages

    @property
    def unified(self) -> bool:
        return self.tile.kernel == "unified"

    @property
    def frames_per_tile(self) -> int:
        return self.tile.frames_per_tile

    def kernel_kwargs(self) -> dict:
        """kwargs for ops.viterbi_decode_frames, ready to splat."""
        return dict(unified=self.unified,
                    frames_per_tile=self.tile.frames_per_tile,
                    pack_survivors=self.pack_survivors, radix=self.radix,
                    layout=Layout(self.tile.layout).value,
                    bm_dtype=self.tile.bm_dtype,
                    block_frames=self.block_frames, overlap=self.overlap)

    def cache_key(self) -> tuple:
        """Stable, hashable identity of the full plan, with the JAX
        package's tuple structure: everything that changes the launched
        decode (kernel knobs, block decomposition) or the launch geometry
        (chunk sizing across devices)."""
        return (*self.tile.cache_key(), bool(self.pack_survivors),
                int(self.radix), int(self.chunk_frames),
                int(self.num_devices), int(self.block_frames),
                int(self.overlap))

    def fingerprint(self) -> str:
        """Short hex digest of cache_key(), the same across processes."""
        import hashlib
        return hashlib.sha1(repr(self.cache_key()).encode()).hexdigest()[:10]


def measure_plan(trellis: Trellis, spec: FrameSpec, plan: DecodePlan, *,
                 reps: int = 2, frames: int | None = None,
                 device=None) -> dict:
    """Time one DecodePlan with real launches of the kernels it selects.

    One warm-up call (it also builds the kernels), then ``reps`` timed
    calls of ``ops.viterbi_decode_frames``, keeping the minimum. On the
    card each call is timed with CUDA events; on the CPU (``device="cpu"``,
    the plain versions) with the host clock. ``frames`` defaults to the
    plan's ``chunk_frames``. Returns the tune-DB record
    ``{ms, mbps, frames, reps, interpret, timer, fingerprint}``, where
    ``interpret`` says the plain version ran instead of the kernels (the
    JAX record's Pallas interpret flag)."""
    from . import ops
    dev = _resolve_device(device)
    F = int(frames if frames is not None else plan.chunk_frames)
    rng = np.random.default_rng(0)
    llr = torch.from_numpy(rng.standard_normal(
        (F, spec.frame_len, trellis.beta)).astype(np.float32)).to(dev)
    kw = plan.kernel_kwargs()

    def launch():
        return ops.viterbi_decode_frames(llr, trellis, spec, device=dev,
                                         **kw)

    cuda = dev.type == "cuda"
    launch()                                  # build + warm-up
    best = math.inf
    for _ in range(max(1, int(reps))):
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            launch()
            t1.record()
            t1.synchronize()
            sec = t0.elapsed_time(t1) / 1e3
        else:
            c0 = time.perf_counter()
            launch()
            sec = time.perf_counter() - c0
        best = min(best, sec)
    return {"ms": best * 1e3, "mbps": F * spec.f / best / 1e6, "frames": F,
            "reps": int(reps), "interpret": not cuda,
            "timer": "cuda_events" if cuda else "host_clock",
            "fingerprint": plan.fingerprint()}


#: What ``layout='auto'`` takes, for both kernels. On Hopper the layout
#: changes no shared memory, so both layouts plan the same tile. The
#: unified kernel keeps its survivors on chip, where the layout does
#: nothing. For the split path it orients the survivor stream in device
#: memory, and the lane stream measured faster on the H100 (chip_smoke.py's
#: split timings, PERF.md): the forward kernel writes each frame's words
#: into a row of its own, and the traceback kernel reads either layout in
#: the same time. ``measure=True`` still times the other layout.
AUTO_LAYOUT = Layout.LANE


def _measure_candidates(trellis: Trellis, plan_spec: FrameSpec,
                        analytic: DecodePlan, *, layout, unified: bool,
                        pack_survivors: bool, radix: int, bm_dtype: str,
                        budget: int, limits: DeviceLimits, num_devices: int,
                        bf: int, ov: int, chunk_frames, top_k: int,
                        device=None, frames: int | None = None):
    """Top-k candidate plans for the timing pass: the analytic winner, the
    other layout at the same tile (layout='auto' only: the measurement
    second-guesses the layout rule), and the half/double tile variants.
    Deduped by cache_key; analytic order kept so ties resolve to the
    model's choice."""
    tiles = [analytic.tile]
    ft0 = analytic.tile.frames_per_tile
    warp = (thread_mapping(trellis, unified) and not thread_mapping(
        trellis, unified, frames, device))
    tile_kw = dict(unified=unified, pack_survivors=pack_survivors,
                   radix=radix, bm_dtype=bm_dtype, budget=budget,
                   limits=limits, registers=analytic.tile.registers,
                   device=device, frames=frames, warp=warp)
    if layout == "auto":
        other = (Layout.SUBLANE if analytic.tile.layout is Layout.LANE
                 else Layout.LANE)
        tiles.append(_tile_at(trellis, plan_spec, ft0, layout=other,
                              **tile_kw))
    cap = candidate_tiles(trellis, unified=unified, warp=warp)[-1]
    for ft in (ft0 // 2, ft0 * 2):
        if 1 <= ft <= cap:
            tiles.append(_tile_at(trellis, plan_spec, ft,
                                  layout=analytic.tile.layout, **tile_kw))
    out, seen = [], set()
    for t in tiles:
        cf = (int(chunk_frames) if chunk_frames is not None
              else 2 * max(1, t.frames_per_tile // bf) * num_devices)
        p = DecodePlan(t, pack_survivors, radix, cf, num_devices, bf, ov)
        if p.cache_key() not in seen:
            seen.add(p.cache_key())
            out.append(p)
    return out[:max(1, int(top_k))]


def _load_kernels(unified: bool) -> None:
    """Build (at first use) and load every kernel a plan launches: B1, or
    B3 and the traceback kernel. A build failure raises here, at planning
    time, before any launch."""
    if unified:
        from .viterbi_unified import kernel_library
        kernel_library()
    else:
        from .traceback_frames import kernel_library as tb_library
        from .viterbi_fwd import kernel_library as fwd_library
        fwd_library()
        tb_library()


def plan_decode(trellis: Trellis, spec: FrameSpec, *, unified: bool = True,
                pack_survivors: bool = True, radix: int = 4,
                bm_dtype: str = "float32", layout="auto",
                smem_budget: int | None = None, num_devices: int = 1,
                chunk_frames: int | None = None,
                max_frames: int | None = None,
                frames_per_tile: int | None = None,
                block_frames: int | str = 1,
                overlap: int | None = None,
                measure: bool = False, tunedb: TuneDB | None = None,
                measure_top_k: int = 3, measure_reps: int = 2,
                measure_frames: int | None = None,
                device=None) -> DecodePlan:
    """Plan the whole decode: kernel, layout, tile, and chunk geometry.

    ``layout='auto'`` takes ``lane`` (``AUTO_LAYOUT`` gives the reason).
    ``chunk_frames`` defaults to two tiles per device.
    ``frames_per_tile`` pins the tile instead of planning it.
    ``block_frames``/``overlap`` (an int, or ``"auto"``) plan the tile for
    the derived per-block spec; tiles then count blocks, while
    ``chunk_frames`` stays in outer frames.

    ``measure=True`` times the top-k candidates (``_measure_candidates``)
    on ``device`` (``measure_plan``) and keeps the one with the highest
    measured Mb/s. Timings persist in the tune DB (``tunedb=``, default
    ``TUNE_DB``) keyed by ``DecodePlan.fingerprint()`` x
    ``platform_id(device)``, so a plan is measured once per (card, code).

    On a card, planning loads the libraries of the kernels the plan
    launches (``_load_kernels``): a build failure raises here, never at a
    later launch.

    Every call runs under a ``plan_decode`` tracing span whose attributes
    carry the chosen plan and its shared memory against the budget and,
    under ``measure=True``, the measured ms and Mb/s and how many
    candidates came from the DB.
    """
    with get_tracer().span("plan_decode") as sp:
        spec.validate()
        device = _resolve_device(device)
        if device.type == "cuda":
            _load_kernels(unified)
        limits = device_limits(device)
        budget = (limits.smem_per_block if smem_budget is None
                  else int(smem_budget))
        bf, ov = resolve_block(trellis, spec, block_frames, overlap)
        plan_spec = spec.blocked(bf, ov) if bf > 1 else spec
        eff_max = (max_frames * bf if (max_frames is not None and bf > 1)
                   else max_frames)
        lay = AUTO_LAYOUT if layout == "auto" else Layout(layout)
        if frames_per_tile is not None:
            tile = _tile_at(trellis, plan_spec, int(frames_per_tile),
                            unified=unified, pack_survivors=pack_survivors,
                            radix=radix, layout=lay, bm_dtype=bm_dtype,
                            budget=budget, limits=limits,
                            registers=kernel_registers(
                                trellis, unified=unified, device=device),
                            device=device, frames=eff_max)
        else:
            tile = plan_tiles(trellis, plan_spec,
                              pack_survivors=pack_survivors, radix=radix,
                              smem_budget=budget, max_frames=eff_max,
                              unified=unified, layout=lay, bm_dtype=bm_dtype,
                              device=device)
        chunk = (int(chunk_frames) if chunk_frames is not None
                 else 2 * max(1, tile.frames_per_tile // bf) * num_devices)
        plan = DecodePlan(tile, pack_survivors, radix, chunk,
                          num_devices, bf, ov)
        if measure:
            db = tunedb if tunedb is not None else TUNE_DB
            if frames_per_tile is not None:
                candidates = [plan]       # pinned tile: measure + record it
            else:
                candidates = _measure_candidates(
                    trellis, plan_spec, plan, layout=layout, unified=unified,
                    pack_survivors=pack_survivors, radix=radix,
                    bm_dtype=bm_dtype, budget=budget, limits=limits,
                    num_devices=num_devices, bf=bf, ov=ov,
                    chunk_frames=chunk_frames, top_k=measure_top_k,
                    device=device, frames=eff_max)
            plat = platform_id(device)
            records, fresh = [], 0
            for cand in candidates:
                rec = db.get(cand.fingerprint(), plat)
                if rec is None:
                    rec = measure_plan(trellis, spec, cand,
                                       reps=measure_reps,
                                       frames=measure_frames, device=device)
                    db.put(cand.fingerprint(), rec, plat)
                    db.record_measure()
                    fresh += 1
                records.append((cand, rec))
            analytic_fp = plan.fingerprint()
            plan, best = max(records,
                             key=lambda pr: pr[1].get("mbps", 0.0))
            tile = plan.tile
            sp.set(measured_ms=round(float(best["ms"]), 4),
                   measured_mbps=round(float(best["mbps"]), 4),
                   measure_candidates=len(records), measure_new=fresh,
                   measure_cached=len(records) - fresh,
                   analytic_fingerprint=analytic_fp)
        sp.set(kernel=tile.kernel, layout=Layout(tile.layout).value,
               frames_per_tile=tile.frames_per_tile,
               bm_dtype=str(tile.bm_dtype),
               chunk_frames=int(plan.chunk_frames),
               num_devices=int(num_devices), block_frames=int(bf),
               overlap=int(ov), smem_bytes=tile.smem_bytes,
               smem_budget=tile.budget, fits=tile.fits,
               frames_per_sm=tile.frames_per_sm,
               registers=tile.registers, fingerprint=plan.fingerprint())
        return plan
