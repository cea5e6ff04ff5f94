#!/usr/bin/env python3
"""Drive the PyTorch port's decode paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card,
`nvcc` and PyTorch built for CUDA. It imports the port (`src/repro_torch`)
and nothing of JAX. Phases, one line each or more; any failure exits
non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — nvcc builds every kernel of the paths from `kernels/csrc`, one
             process per source, all started together; prints the seconds
             and, for the two ACS kernels, the -Xptxas -v registers and
             spills of every instantiation (registers per lane R x beta
             2..8 and the run-time beta past it; the large codes'
             one-block kernels per butterflies a thread, table and
             per-edge sums; the wide and cluster kernels; B1's thread
             mapping's, registers, local bytes and spills per k and
             beta), and the
             one-block kernels' blocks resident an SM at beta 2 and 9
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
             autotune.H100_BLOCKS on an H100).
3. parity  — each kernel's wrapper against its plain torch version on the
             card, exactly (torch.equal), over the codes K=3, 4 (beta=3),
             5, 6, 7, 9, 11 and the large codes K=12, 13, 14, 15 (beta=4)
             and K=12 beta=8 (the cluster mapping's one-block form: one
             block a frame, path metrics in shared memory), and the low
             rates on the same mappings with beta at run time (K=5
             beta=12, K=7 beta=9, 12, 16, K=9 beta=10, K=11 beta=9, K=12,
             13, 15 beta=9). Unified
             kernel: the knob grid, bf16/f16 LLRs, frames too long for
             shared memory. Forward kernel: sel and amax over the same
             grid, both layouts. Traceback kernel: against the plain
             serial/parallel chase over the forward kernel's outputs, and
             both of its chases (staged, direct) pinned at K=7 and K=11
             on a sliced stream. Both paths through ops with a ragged
             frame count. The block-parallel decode (block_frames > 1)
             through both kernels against the CPU's, and at full overlap
             against the unblocked decode. The wide mapping (every code
             past k = 15, k and beta at run time; at 16 <= k <= 19 one
             thread-block cluster of 2^(k-15) blocks a frame, else one
             block a frame): K=16, 17, 18, 19, K=16 beta=3 and 9, all
             three kernels over the same knob grid and starts (every
             cluster size the planner picks), and K=16 beta=2 and 9 off
             a cluster (path metrics in device memory).
4. main    — make_decoder(backend="kernel"), then
             make_decoder(backend="kernel_split"), each at full size: K=7,
             n = 2^22 bits, Eb/N0 = 3 dB, rates 1/2 and 3/4. Launch counts
             are set to 0 just before each path and read just after (split:
             one forward and one traceback launch per call, no unified
             launch; both: one framing-kernel launch per call, which clips
             too: the rate-1/2 kernel's at rate 1/2, the punctured kernel's,
             which also depunctures and pads to the tile, at rate 3/4); the
             bits must equal backend="reference" on the same LLRs (plain
             torch clip, depuncture and framing: no framing-kernel launch),
             and the split bits the unified bits, and the
             rate-1/2 BER must be below 1e-3; every B1 launch of the K=7
             path (16,384 frames) must run on the thread mapping
             (``mapping_launches``). Then the wide path: K=16 rate
             1/2 at the main frame, 132 frames, through both kernel
             backends (counts set to 0 just before each and read just
             after), bits equal to the reference backend's; and the
             large codes' path the same way: Galileo's K=15 rate-1/4
             code at the main frame, 132 frames of its (n, 4) LLRs at
             0 dB; and the low rates' path: K=7 rate 1/9 (the register
             mapping with beta at run time), 4224 frames of its (n, 9)
             LLRs at -5 dB.
5. time    — each kernel at the main path's shape with CUDA events, beside
             its plain version and its bound; the clip-and-frame kernel
             (frame_llr.cu) on the main path's LLRs, poisoned with NaN,
             +-Inf, values past the clip and -0.0, clip on and off: bit
             for bit against its plain version (ATen's isfinite, where,
             clamp, pad and index), in turns with it, beside its bytes
             bound (LLRs read once, frames written once, at 3.35 TB/s),
             and the same at the benchmark cells' calls (2^24 x 2, 2^26 x
             2 clip off, 2^20 x 4); the punctured framing kernel at the
             k7_r34_batch call (2^24 stages at rate 3/4, padded to tile
             64), bit for bit against its plain version and the ATen chain
             it replaces, in turns with both; the unified kernel's knob
             sweep and its auto tile against tile 4 (must be within 2 %);
             B1 at K=7 on the thread mapping against the warp mapping,
             both forced, in turns, at the main shape, the K=7 cells'
             calls, a stream chunk (64 frames), a server batch (4,096)
             and the card's threshold (8,448), beside the mapping the
             launch takes unforced; the split path's layouts; the traceback's staged and direct
             chases in turns, at K=7 (lane and sublane, packed, unpacked,
             serial) and K=11 (4096 frames), beside the shape rule's pick
             and the bound; B1 and B3 at K=12, 13, 14, 15 and K=12 beta=8
             (132 or 264 frames, and 1056 for K=12 and K=15) beside their
             bounds, with the one-block form's threads, resident blocks
             and where B1's survivors are;
             B1, B3 and the traceback on the wide mapping at K=16, 17,
             18, 19 and at the low rates (K=7 beta=9 and 16 and K=9
             beta=10 at 4224 frames, K=11 beta=9 at 1056, K=13 beta=9
             at 264, K=15 beta=9 at 132), beside their bounds and plain versions,
             with the mapping: the cluster size, the clusters resident
             and each block's shared memory, or the tile or threads and
             the frames an SM;
             the whole split call against the
             whole unified call (median and quartiles over 20 rounds, and
             the host's dispatch time per call); plan_decode(measure=True)
             into a temporary tune DB, then read back from it. Beside each
             ACS kernel's time, the resident frames per SM and registers
             the planner predicts.
6. profile — a torch.profiler breakdown of one warm rate-1/2 make_decoder
             call per backend: device time by kernel, the device's busy
             share, and the glue's share (device time outside the decode
             kernels: clip, depuncture, frame gather, pad) of the call.
7. stream  — stream_decode's path (make_stream_decoder, push, flush) at
             K=7, rates 1/2 and 3/4 (the main path's frames), n = 2^24
             bits or the power of two that spans STREAM_WAVES chunks
             (2^26 on the thread mapping), pushed in seeded random slices
             of 1-64 kbit (raw symbols at rate 3/4, so slices cut
             puncturing periods), at the one-wave chunk (the plan's
             resident frames per SM x SMs), then n = 2^18 at the
             planner's default chunk. Launch counts
             set to 0 just before each run and read just after: B1 once
             per chunk, nothing else (the stream frames on its own). Bits must equal make_decoder on the
             card. Prints Mb/s and the host ms per chunk by phase
             (framing, copy in, dispatch, drain). Then the no-sync check:
             behind a spinning kernel, just after chunk i+1 is dispatched
             (depth 1), chunk i's event must still be pending.
8. serve   — one DecodeServer(slots=64, max_sessions=256) on the card:
             256 sessions (192 K=7 rate 1/2, 64 rate 3/4, backend
             "kernel", chunk_frames=64: 4096 frames a full launch), each
             2^16 bits pushed in seeded random slices interleaved across
             sessions, step/poll until every session is closed. Every
             session's bits must equal make_decoder; plan-cache traces
             must equal the distinct (bucket, batch) programs; every
             fault counter must be 0; B1's launches must equal the
             server's. Prints windows/s, Mb/s, and the p50/p99 of step
             time and of window latency. Then drain(checkpoint) and
             restore mid-stream (bits equal), a seeded FaultInjector run
             (launch errors and one poisoned push: counters equal the
             schedule, healthy sessions' bits equal), and one kernel_split
             bucket of 16 sessions (B3 and the traceback kernel, bits
             equal).
9. mesh    — the frame-sharded decode (repro_torch.distributed). The
             sharded frame decoder at the main shape over the meshes
             [cuda:0] and [cuda:0, cuda:0], and the latter again at one
             frame fewer (padding): bits equal the unsharded frame
             decoder, B1 launches equal the shards, ms beside the
             unsharded call's. stream_decode's path over [cuda:0, cuda:0]
             at rates 1/2 and 3/4 (n = 2^22 at one wave per shard, 2^16 at
             the mesh's default chunk): bits equal make_decoder, B1
             launches equal chunks x shards, and the no-sync check. A
             DecodeServer over it, 16 sessions (12 rate 1/2, 4 rate 3/4):
             bits equal make_decoder, B1 launches equal the server's x
             shards; drain(checkpoint) and restore under the mesh, bits
             equal. With two or more cards the same checks over
             frame_mesh() (every card); with one, a line says so. Then the
             dry run (launch/viterbi_dryrun.py --run) at 10^8 bits on the
             local mesh: measured Gb/s against decode_roofline's bound.
10. lm      — the LM scaffold's serve path (repro_torch.models,
             launch/serve.py), float32 matmul precision "highest". Every
             decoder-only architecture's reduced config in float32, the
             same weights on the card and on the CPU: prefill and 4
             decode steps, logits within 1e-4. Incremental decode against
             the parallel forward on the card for five architectures, in
             float32 (1e-4) and bfloat16 (5e-2). Then Qwen3-32B cut to 4
             layers and Qwen3-235B-A22B cut to 2, every width as
             published, bfloat16, random weights from the seed:
             serve_requests with 6 requests, 4 slots, 12 tokens each,
             max_seq 96; tokens in range, incremental == parallel over 4
             positions within 2^-5 of the largest logit; prints tokens/s,
             the median decode step against its bound (the weight bytes
             over 3.35 TB/s), peak memory and the card's name and power
             limit. No kernel of its own: its products are torch.matmul.
11. train   — the LM scaffold's training path (repro_torch.optim, data,
             train; models/layers.py's autograd Functions), float32 matmul
             precision "highest". (a) Every reduced architecture in
             float32, the same weights and batch on the card and the CPU:
             loss (1e-5 relative), every gradient leaf (1e-4 of its
             largest magnitude), the params after 2 AdamW steps (1e-4).
             (b) The flash backward and rms_norm's Function against
             autograd through _sdpa_full and the fp32 RMSNorm, at
             Qwen3-32B's attention shape (H=64, KV=8, hd=128, S=2048,
             chunk 1024) and d_model 5120, float32 (1e-4) and bfloat16
             (2^-5). (c) train_loop on the card with a failure injected
             at step 7: one restore, replayed losses equal the first run
             and an uninterrupted run's, a fresh loop resumes. (d)
             Qwen3-32B cut to 4 layers, every width as published, bf16
             params and fp32 moments, remat "full", batch 2 x 2048 of
             learnable data, 5 steps of make_train_step, then a profiled
             big-batch step and make_accum_train_step(accum=2) from the
             same state (losses within 5e-2), and one step timed in two
             parts (loss and gradients, AdamW update); prints losses,
             the median step ms and tokens/s against the step's bound
             (6 N T over 989 TFLOP/s, 22 B a param over 3.35 TB/s),
             device busy and matrix-product shares, peak memory, the
             card's name and power limit. No kernel of its own.
12. sharded — the training path on DTensors over a ('data', 'model')
             DeviceMesh (repro_torch.distributed). On card 0, an nccl
             group of world 1 (a FileStore in a temporary directory) and
             a (1, 1) mesh: every reduced config in float32 against the
             plain step (loss and grad norm 1e-5 relative, the first
             step's grads 1e-4 of each leaf's max, params after 2 AdamW
             steps 2e-4); Qwen3-32B cut to 4 layers, every width as
             published, phase 11 (d)'s setup, 4 sharded steps against 4
             plain ones from the same init (losses 1e-5 relative, params
             within 2e-4 plus one bf16 rounding) and the two medians
             (DTensor's overhead); launch.dryrun's trace of the same step
             on a fake process group (traced before the group starts):
             its peak within 10 % of max_memory_allocated over the steps
             from the placed state, t_bound beside the step ms;
             make_compressed_train_step at world 1
             (finite loss, g_hat == q * scale, feedback nonzero). With 2
             or more cards, one process a card (mp.spawn, nccl,
             FileStore): the reduced configs on (2, 2), (1, 4), (4, 1)
             against the plain step on card 0; with 4, Qwen3-32B/4L on
             (2, 2) against the one-card step (bf16: losses 5e-2, params
             3e-2), Qwen3-235B-A22B cut to 2 of 94 layers at full width
             on (1, 4) (EP: 32 experts a card) and (2, 2), batch 4 x
             2048, the first 3 steps of a 1000-step warmup (losses
             within 5e-2 across the meshes; step ms, tokens/s against
             6 N_active T over 4 x 989 TFLOP/s, peak memory per card;
             on card 0 the dry run's trace, made in the parent before
             the spawn: peak within 10 %, t_bound, and its collectives
             equal by kind to op_cost.CollectiveCounter's over the first
             real nccl step),
             and the elastic rescale (2
             steps on (2, 2), a checkpoint, elastic_rescale onto (2, 1)
             over cards 0-1: the next loss within 1e-5). A check the
             machine has too few cards for prints a line saying so.
             `python3 chip_smoke.py --sharded` runs this phase alone.

The line before the last is a JSON `kernels` line (B1, B3, the traceback,
the clip-and-frame kernel and the punctured framing kernel, with each
kernel's launches on the main
path, and ``launches_stream``/``launches_serve``/
``launches_mesh`` on phases 7, 8 and 9, ``launches_wide``,
``launches_large`` and ``launches_lowrate`` on phase 4's K=16, Galileo
K=15 and K=7 rate-1/9 paths; B1's and
B3's ``large_codes`` times, the three kernels'
``wide_codes`` rows, the traceback's ``modes`` and the framing kernel's
``cells``); each decode kernel's bound comes from launch/roofline.py, the
framing kernel's from its bytes over the same HBM rate. The last line is the JSON `ok` line with the device.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_BITS = 1 << 22
EBN0_DB = 3.0
BER_LIMIT = 1e-3
SEED = 0
#: The auto tile may be at most this much slower than tile 4 (B1).
AUTO_TILE_SLACK = 0.02
#: Whole make_decoder calls: rounds per backend, calls back to back each.
E2E_ROUNDS = 20
E2E_CALLS = 5
#: K=3 (S=4: eight frames a warp), K=4 beta=3, K=5, K=6 (S=32: one
#: register a lane), K=7, K=9 and K=11 (S=1024: 32 registers a lane);
#: then the large codes (the cluster mapping's one-block form: one block a
#: frame, path metrics in shared memory): K=12 (256 threads of 4
#: butterflies), K=13 (128 of 16), the Galileo (15, 1/4) code (512 of 16),
#: K=14 (256 of 16) and a K=12 rate-1/8 code (a 256-entry butterfly table
#: a stage).
CODES = [(3, (0o7, 0o5)), (4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
         (6, (0o65, 0o57)), (7, (0o171, 0o133)), (9, (0o753, 0o561)),
         (11, (0o3345, 0o3613)), (12, (0o4335, 0o5723)),
         (13, (0o10533, 0o17661)),
         (15, (0o46321, 0o51271, 0o63667, 0o70535)),
         (14, (0o21645, 0o35661)),
         (12, (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163,
               0o7555))]
LARGE_K = 12
#: Frames per parity call: 12, and 4 (one tile) for a large code (its
#: plain version is S = 2^14 states wide at K=15).
PARITY_FRAMES = {False: 12, True: 4}
#: Frames of the large codes' timing (one and two frames per SM at 132
#: SMs): K=12 and K=13 at 264, K=14 and K=15 at 132; and, for K=12 and
#: K=15, LARGE_FULL_FRAMES (eight frames an SM), where the resident blocks
#: an SM show.
LARGE_TIME_FRAMES = {12: 264, 13: 264, 14: 132, 15: 132}
LARGE_FULL_FRAMES = 1056
#: The wide mapping's codes (k > 15; k and beta at run time): K=16, 17, 18
#: at rate 1/2 and K=16 at rate 1/3 (a cluster of 2, 4, 8, 2 blocks a
#: frame, path metrics in the cluster's shared memory), K=19 at rate 1/2 (a
#: cluster of 16 where the card holds one, else the device-memory path);
#: distinct polynomials with the top and bottom taps set (the cluster's
#: one-metric butterfly table); then two K=16 codes on a cluster of 2 that
#: take its other branch metrics: one polynomial without its bottom tap
#: (the four-metric table) and rate 1/9 (per-edge sums).
WIDE_CODES = [(16, (0o135417, 0o163251)), (17, (0o247153, 0o365715)),
              (18, (0o523571, 0o634657)),
              (16, (0o135417, 0o163251, 0o117643)),
              (19, (0o1234567, 0o1654321)),
              (16, (0o135417, 0o163250)),
              (16, (0o135417, 0o163251, 0o117643, 0o100001, 0o123457,
                    0o145673, 0o167011, 0o110101, 0o133333))]
#: Rates below 1/8 at k <= 15 (the fast mappings with beta at run time: the
#: register mapping to k = 11, the one-block form's per-edge sums past it):
#: K=5 rate 1/12 (top taps only), K=7 at rates 1/9, 1/12 and 1/16, K=9
#: rate 1/10, K=11 rate 1/9 (one polynomial without its bottom tap: four
#: sums a butterfly), K=12, 13 and 15 at rate 1/9.
LOW_RATE_CODES = [
    (5, (0o21, 0o23, 0o25, 0o27, 0o31, 0o33, 0o35, 0o37, 0o20, 0o22, 0o24,
         0o26)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173,
         0o103, 0o111, 0o125)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173,
         0o103, 0o111, 0o125, 0o137, 0o141, 0o153, 0o163)),
    (9, (0o561, 0o753, 0o711, 0o647, 0o525, 0o457, 0o673, 0o535, 0o743,
         0o607)),
    (11, (0o3345, 0o3613, 0o2011, 0o3777, 0o2525, 0o3131, 0o2663, 0o3455,
          0o2002)),
    (12, (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163, 0o7555,
          0o4001)),
    (13, (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577, 0o16243,
          0o14101, 0o17017)),
    (15, (0o46321, 0o51271, 0o63667, 0o70535, 0o41111, 0o57773, 0o62345,
          0o77777, 0o40001))]
#: Frames per wide parity call.
WIDE_PARITY_FRAMES = 3
#: Bytes of survivors (L x S x 8: pack_bits' int64 words) and branch
#: metrics (L x 2^(beta-1), twice) a plain version holds at a time in the
#: wide timing rows: K=18 at 132 frames runs in 25, K=7 beta=16 at 4224 in
#: 42.
PLAIN_WIDE_BYTES = 1 << 33
#: The wide main path: K=16 rate 1/2 at the main frame, one frame per SM.
WIDE_MAIN_FRAMES = 132
#: The large codes' main path: Galileo's K=15 rate-1/4 code at the main
#: frame, one frame per SM, at an Eb/N0 where its BER is not 0.
LARGE_MAIN_FRAMES = 132
LARGE_MAIN_EBN0_DB = 0.0
#: The low rates' main path: K=7 rate 1/9 at the main frame, 4224 frames
#: (32 an SM), at an Eb/N0 where its BER is not 0 (nine symbols a bit).
LOWRATE_MAIN_FRAMES = 4224
LOWRATE_MAIN_EBN0_DB = -5.0
#: The wide timing rows: (code, frames): K=16, 17, 18, 19 at 132 frames
#: (one frame a cluster of 2, 4, 8, 16 blocks, the clusters resident taking
#: frames in turn); and the low rates on the fast mappings: K=7 beta=9 and
#: 16 and K=9 beta=10 at 4224 (32 and 17 frames an SM), K=11 beta=9 at
#: 1056 (8 an SM), K=13 beta=9 at 264 (2) and K=15 beta=9 at 132 (1).
WIDE_TIME = [(WIDE_CODES[0], 132), (WIDE_CODES[1], 132),
             (WIDE_CODES[2], 132), (WIDE_CODES[4], 132),
             (LOW_RATE_CODES[1], 4224), (LOW_RATE_CODES[3], 4224),
             (LOW_RATE_CODES[4], 4224), (LOW_RATE_CODES[5], 1056),
             (LOW_RATE_CODES[7], 264), (LOW_RATE_CODES[8], 132)]
DECODE_KERNELS = ("viterbi_unified_kernel", "viterbi_fwd_kernel",
                  "traceback_frames_kernel", "viterbi_unified_block_kernel",
                  "viterbi_fwd_block_kernel",
                  "viterbi_unified_block_pe_kernel",
                  "viterbi_fwd_block_pe_kernel", "viterbi_unified_wide_kernel",
                  "viterbi_fwd_wide_kernel", "viterbi_unified_cluster_kernel",
                  "viterbi_fwd_cluster_kernel",
                  "viterbi_unified_thread_kernel")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    """One call on the host clock, synchronised (for the plain versions,
    which are loops of small launches)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(kernel: str, spec, F: int, trellis=None, **knobs):
    """(bound_ms, bound_by, bytes) of one launch of ``kernel`` over F
    frames of ``trellis`` (default the K=7 code): the work
    launch/roofline.py counts, over the H100's data-sheet peaks."""
    from repro_torch.core.trellis import STD_K7
    from repro_torch.launch.roofline import kernel_bound, kernel_work
    nbytes, nops = kernel_work(kernel, trellis or STD_K7, spec, F, **knobs)
    return (*kernel_bound(nbytes, nops), nbytes)


def card_name_power() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch
    print(card_name_power(), flush=True)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def _ptxas_spills(built, kernel: str) -> dict:
    """Spill stores (bytes) by (R, beta) from the -Xptxas -v report: a
    'Function properties for <kernel><R, BETA>' line, then its stack and
    spill line."""
    spills, key = {}, None
    for ln in built.log.splitlines():
        m = re.search(r"Function properties for \w*" + kernel +
                      r"ILi(\d+)ELi(\d+)E", ln)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            continue
        sp = re.search(r"(\d+) bytes spill stores", ln)
        if sp and key is not None:
            spills[key] = int(sp.group(1))
        key = None
    return spills


def register_report(built, kernel: str, attrs) -> str:
    """Registers (cudaFuncGetAttributes) and ptxas spill stores of every
    instantiation of one ACS kernel: per registers per lane R, beta 2..8
    and the run-time beta (BETA = 0; "wide" where the kernel runs the
    wide mapping instead); then the large codes' one-block
    kernels (``<kernel>`` with ``_block`` before ``_kernel``: the table,
    beta <= 8, whose registers do not depend on beta; ``_block_pe``: the
    per-edge sums, beta 9), one instantiation per butterflies a thread NB,
    at k = 12..15."""
    import ctypes
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    block_kernel = kernel.replace("_kernel", "_block_kernel")
    pe_kernel = kernel.replace("_kernel", "_block_pe_kernel")
    spills = _ptxas_spills(built, kernel)
    unified = kernel.startswith("viterbi_unified")
    rows = []
    for k in (2, 7, 8, 9, 10, 11):
        R = max(1, (1 << (k - 1)) // 32)
        regs = []
        for beta in range(2, 10):
            if autotune.wide_mapping(make_trellis(k, ((1 << k) - 1,) * beta),
                                     unified):
                regs.append("wide")     # B3 at FWD_WIDE_K past beta = 8
                continue
            out = (ctypes.c_int * 3)()
            if attrs(k, beta, out) != 0:
                raise RuntimeError(f"{kernel} k={k} beta={beta}: no "
                                   f"function attributes")
            key = (R, beta if beta <= 8 else 0)     # BETA = 0: run time
            regs.append(f"{out[0]}/{spills.get(key, '?')}")
        rows.append(f"R={R}: " + " ".join(regs))
    for k in (12, 13, 14, 15):
        regs = set()
        for beta in range(2, 9):
            out = (ctypes.c_int * 3)()
            if attrs(k, beta, out) != 0:
                raise RuntimeError(f"{block_kernel} k={k} beta={beta}: no "
                                   f"function attributes")
            regs.add(out[0])
        T = autotune.large_threads(make_trellis(k, ((1 << k) - 1,) * 2))
        nb = (1 << (k - 2)) // T
        low = make_trellis(k, ((1 << k) - 1,) * 9)
        T9 = autotune.large_threads(low)
        nb9 = (1 << (k - 2)) // T9
        out = (ctypes.c_int * 3)()
        if attrs(k, 9, out) != 0:
            raise RuntimeError(f"{block_kernel} k={k} beta=9: no function "
                               f"attributes")
        rows.append(f"k={k} {block_kernel} T={T} NB={nb}: "
                    f"{'/'.join(map(str, sorted(regs)))} registers, "
                    f"{_spill_of(built, block_kernel + f'ILi{nb}E')} bytes "
                    f"spilled; {pe_kernel} (beta 9) T={T9} NB={nb9}: "
                    f"{out[0]} registers, "
                    f"{_spill_of(built, pe_kernel + f'ILi{nb9}E')} bytes "
                    f"spilled")
    return (f"{kernel} registers/spilled bytes, beta 2..8 and run-time "
            f"beta (R=1 serves k<=6; k=12..15: the one-block kernel): "
            + "; ".join(rows))


def _spill_of(built, function: str) -> str:
    """Spill stores (bytes) of the first ptxas report whose function name
    matches ``function`` (a regex), or '?'."""
    seen = False
    for ln in built.log.splitlines():
        if re.search(r"Function properties for \w*" + function, ln):
            seen = True
            continue
        sp = re.search(r"(\d+) bytes spill stores", ln)
        if seen and sp:
            return sp.group(1)
    return "?"


def wide_register_report(built, kernel: str, attrs, cluster_attrs) -> str:
    """Registers (cudaFuncGetAttributes) and ptxas spill stores of the
    wide mapping's kernel (``<kernel>`` with ``_wide`` before ``_kernel``,
    one instantiation for every code off a cluster: a K=20 code's
    attributes) and of its cluster kernels (``_cluster``, per butterflies
    a thread NB and table or per-edge branch metrics; the attributes of
    K=16 beta=2 on 2 blocks and K=16 beta=9)."""
    import ctypes
    wide = kernel.replace("_kernel", "_wide_kernel")
    cl = kernel.replace("_kernel", "_cluster_kernel")
    out = (ctypes.c_int * 3)()
    if attrs(20, 2, out) != 0:
        raise RuntimeError(f"{wide}: no function attributes")
    rows = [f"{wide} (codes past k=15 off a cluster): {out[0]} "
            f"registers, {_spill_of(built, wide)} bytes spilled, {out[2]} "
            f"threads a block at most"]
    regs = {}
    for beta in (2, 9):
        if cluster_attrs(16, beta, 2, out) != 0:
            raise RuntimeError(f"{cl}: no function attributes")
        regs[beta] = (out[0], out[2])
    spills = " ".join(
        f"NB={nb}{' table' if tbl else ' per-edge'}:"
        f"{_spill_of(built, cl + f'ILi{nb}ELb{int(tbl)}')}"
        for nb in (1, 2, 4, 8, 16) for tbl in (True, False))
    rows.append(f"{cl} (16<=k<=19 on a cluster): {regs[2][0]} registers "
                f"(beta 9: {regs[9][0]}), {regs[2][1]} threads a block at "
                f"most; bytes spilled {spills}")
    return "; ".join(rows)


def thread_register_report(built, attrs) -> str:
    """Registers (cudaFuncGetAttributes), local bytes and ptxas spill
    stores of B1's thread mapping (viterbi_unified_thread_kernel<K,
    BETA>), per k and beta it takes."""
    import ctypes
    from repro_torch.kernels import autotune
    rows = []
    for k in range(autotune.THREAD_MIN_K, autotune.THREAD_MAX_K + 1):
        for beta in range(2, autotune.THREAD_MAX_BETA + 1):
            out = (ctypes.c_int * 3)()
            if attrs(k, beta, out) != 0:
                raise RuntimeError(f"thread kernel k={k} beta={beta}: no "
                                   f"function attributes")
            spill = _spill_of(built, f"viterbi_unified_thread_kernelILi{k}"
                                     f"ELi{beta}E")
            rows.append(f"k={k} beta={beta}: {out[0]}/{out[1]}/{spill}")
    return ("viterbi_unified_thread_kernel registers/local bytes/spilled "
            "bytes: " + "; ".join(rows))


def phase_build():
    from repro_torch.kernels import framing
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    libs = {"viterbi_unified_kernel": vu.kernel_library,
            "viterbi_fwd_kernel": vf.kernel_library,
            "traceback_frames_kernel": tbf.kernel_library,
            "frame_llr_kernel": framing.kernel_library}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in libs.items()}
        built = {k: fut.result() for k, fut in futures.items()}
    wall = time.perf_counter() - t0
    for kernel, b in built.items():
        log("build", f"{b.path.name} nvcc {b.seconds:.1f} s")
    log("build", f"all {len(built)} sources in {wall:.1f} s (parallel)")
    for kernel, attrs in (("viterbi_unified_kernel", "viterbi_unified"),
                          ("viterbi_fwd_kernel", "viterbi_fwd")):
        lib = built[kernel].lib
        log("build", register_report(built[kernel], kernel,
                                     getattr(lib, attrs + "_func_attrs")))
        log("build", wide_register_report(
            built[kernel], kernel, getattr(lib, attrs + "_func_attrs"),
            getattr(lib, attrs + "_cluster_attrs")))
        if attrs == "viterbi_unified":
            log("build", thread_register_report(
                built[kernel], lib.viterbi_unified_thread_attrs))
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    blocks = {name + low: {k: autotune.block_capacity(
        make_trellis(k, ((1 << k) - 1,) * beta), "cuda", unified=unified)
        for k in (12, 13, 14, 15)}
        for name, unified in (("unified", True), ("split", False))
        for low, beta in (("", 2), ("_lowrate", 9))}
    log("build", f"one-block kernels' blocks resident an SM (the "
        f"recursion's shared memory; autotune.H100_BLOCKS on an H100): "
        f"{blocks}")


def _frames(trellis, spec, nframes, gen, dtype):
    """Noisy frames of a random codeword, made on the card from ``gen``."""
    import torch
    from repro_torch.channel.sim import awgn, bpsk
    from repro_torch.core.encoder import encode
    from repro_torch.core.framed import frame_llr
    n = nframes * spec.f
    bits = torch.randint(0, 2, (n,), generator=gen, device=gen.device)
    llr = awgn(bpsk(encode(bits, trellis)), 3.0, gen)    # (n, beta)
    return frame_llr(llr, spec).to(dtype).contiguous()


def _tb_geometry(spec):
    """(f0, v2s, start) as the kernels take them: serial = one subframe."""
    if spec.parallel_tb:
        return spec.f0, spec.v2s, spec.start
    return spec.f, spec.v2, "boundary"


def _check_equal(got, want, what):
    import torch
    if isinstance(got, tuple):
        ok = all(g.dtype == w.dtype and torch.equal(g, w)
                 for g, w in zip(got, want))
    else:
        ok = got.dtype == want.dtype and torch.equal(got, want)
    if not ok:
        raise AssertionError(f"kernel != plain: {what}")


def phase_parity(gen):
    import torch
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu

    specs = [FrameSpec(f=64, v1=20, v2=21),                         # serial
             FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),          # boundary
             FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")]
    counts = {"unified": 0, "forward": 0, "traceback": 0}
    for k, polys in CODES + LOW_RATE_CODES:
        tr = make_trellis(k, polys)
        for spec in specs:
            frames = _frames(tr, spec, PARITY_FRAMES[k >= LARGE_K], gen,
                             torch.float32)
            f0, v2s, start = _tb_geometry(spec)
            for pack in (False, True):
                for radix in (2, 4):
                    for layout in ("lane", "sublane"):
                        for bm in ("float32", "bfloat16"):
                            knobs = dict(trellis=tr, frames_per_tile=4,
                                         pack_survivors=pack, radix=radix,
                                         layout=layout, bm_dtype=bm)
                            kw = dict(knobs, v1=spec.v1, f=spec.f,
                                      v2=spec.v2, f0=f0, v2s=v2s,
                                      start=start)
                            what = f"k={k} {spec} {knobs}"
                            _check_equal(
                                vu.unified_decode_frames_cuda(frames, **kw),
                                vu.unified_decode_frames_plain(frames, **kw),
                                "unified " + what)
                            counts["unified"] += 1
                            fwd = vf.forward_frames_cuda(frames, **knobs)
                            _check_equal(
                                fwd, vf.forward_frames_plain(frames, **knobs),
                                "forward " + what)
                            counts["forward"] += 1
                            tkw = dict(trellis=tr, v1=spec.v1, f=spec.f,
                                       f0=f0, v2s=v2s, start=start,
                                       packed=pack, layout=layout)
                            _check_equal(
                                tbf.traceback_frames_cuda(*fwd, **tkw),
                                tbf.traceback_frames_plain(*fwd, **tkw),
                                "traceback " + what)
                            counts["traceback"] += 1
    # LLRs arriving in bf16/f16, a ragged frame count through ops' padding
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    for k, polys in CODES + LOW_RATE_CODES:
        tr = make_trellis(k, polys)
        for dtype in (torch.bfloat16, torch.float16):
            frames = _frames(tr, spec, 8, gen, dtype)
            kw = dict(trellis=tr, v1=16, f=64, v2=20, f0=16, v2s=20,
                      frames_per_tile=8, pack_survivors=True, radix=4)
            _check_equal(vu.unified_decode_frames_cuda(frames, **kw),
                         vu.unified_decode_frames_plain(frames, **kw),
                         f"unified k={k} {dtype} LLRs")
            fkw = dict(trellis=tr, frames_per_tile=8, pack_survivors=True,
                       radix=4, layout="sublane")
            _check_equal(vf.forward_frames_cuda(frames, **fkw),
                         vf.forward_frames_plain(frames, **fkw),
                         f"forward k={k} {dtype} LLRs")
            counts["unified"] += 1
            counts["forward"] += 1
        frames = _frames(tr, spec, 13, gen, torch.float32)
        for unified in (True, False):
            for layout in ("lane", "sublane"):
                kw = dict(unified=unified, layout=layout, frames_per_tile=8)
                got = ops.viterbi_decode_frames(frames, tr, spec,
                                                device="cuda", **kw)
                want = ops.viterbi_decode_frames(frames.cpu(), tr, spec,
                                                 device="cpu", **kw)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(
                        f"ragged frame count: card != cpu k={k} {kw}")
    # frames too long for shared memory: survivors in device scratch
    # (unpacked K=7 at f=4096, packed K=11 at f=2048, packed K=13 at
    # f=512, packed K=15 at f=64)
    for code, f, pack in ((CODES[4], 4096, False), (CODES[6], 2048, True),
                          (CODES[8], 512, True), (CODES[9], 64, True)):
        tr = make_trellis(*code)
        long_spec = FrameSpec(f=f, v1=45, v2=45)
        frames = _frames(tr, long_spec, 2, gen, torch.float32)
        if tr.k >= LARGE_K:
            assert vu.kernel_library().lib.viterbi_unified_smem_bytes(
                tr.k, tr.beta, long_spec.frame_len, 1, int(pack), 0, 1, 0) > \
                autotune.device_limits("cuda").smem_per_block
        kw = dict(trellis=tr, v1=45, f=f, v2=45, f0=f, v2s=45,
                  frames_per_tile=1, pack_survivors=pack, radix=2)
        _check_equal(vu.unified_decode_frames_cuda(frames, **kw),
                     vu.unified_decode_frames_plain(frames, **kw),
                     f"device-memory survivor scratch k={tr.k}")
        counts["unified"] += 1
    # the traceback's two modes, pinned, on the forward kernel's streams
    # (a sliced sublane stream too): K=7 rows are staged by the rule, K=11
    # unpacked rows are chased in device memory
    spec = FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21)
    for code, pack in ((CODES[4], True), (CODES[4], False),
                       (CODES[6], True), (CODES[6], False)):
        tr = make_trellis(*code)
        frames = _frames(tr, spec, 37, gen, torch.float32)
        for layout in ("lane", "sublane"):
            sel, amax = vf.forward_frames_cuda(
                frames, trellis=tr, frames_per_tile=1, pack_survivors=pack,
                layout=layout)
            sel = sel[..., :33] if layout == "sublane" else sel[:33]
            tkw = dict(trellis=tr, v1=20, f=64, f0=16, v2s=21, packed=pack,
                       layout=layout)
            want = tbf.traceback_frames_plain(sel, amax[:33], **tkw)
            for chase in ("staged", "direct"):
                _check_equal(tbf.traceback_frames_cuda(
                    sel, amax[:33], chase=chase, **tkw), want,
                    f"traceback {chase} k={tr.k} {layout} packed={pack}")
                counts["traceback"] += 1
    wide = phase_parity_wide(gen, specs)
    blocked = phase_blocked(gen)
    log("parity", f"kernel calls equal to the plain version: {counts} "
        f"(codes K=3, K=4 beta=3, K=5, K=6, K=7, K=9, K=11, K=12, K=13, "
        f"K=15 beta=4, K=14, K=12 beta=8; at run-time beta K=5 beta=12, "
        f"K=7 beta=9, 12 and 16, K=9 beta=10, K=11 beta=9, K=12, 13, 15 "
        f"beta=9; pack x radix x layout x "
        f"bm_dtype; serial, boundary, fixed; bf16/f16 LLRs; device-memory "
        f"survivors at K=7, K=11, K=13 and K=15; the traceback's staged and "
        f"direct chase at K=7 and K=11); split and unified ops with a "
        f"ragged F equal to the CPU for every code; {blocked}")
    log("parity", f"wide mapping, kernel calls equal to the plain version: "
        f"{wide} (K=16, 17, 18, 19 beta=2, K=16 beta=3, "
        f"K=16 without a bottom tap, K=16 beta=9; K=16 again off a "
        f"cluster, its path metrics in device memory; "
        f"pack x radix x layout x bm_dtype; serial, boundary, fixed)")


def phase_parity_wide(gen, specs):
    """The wide mapping's codes through the three kernels, each against
    its plain version (torch.equal) over the knob grid and the three
    starts, on the cluster the planner picks (every size from 2 to 16
    that the card holds), and K=16 at beta = 2 and 9 once more off a
    cluster (``_cluster=1``: the path metrics in device memory, as every
    k >= 20 code and k = 16-19 on a card without the cluster run; at
    beta = 9 the wide kernel's per-edge sums). Returns the calls by kernel
    and by cluster."""
    import torch
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    counts = {"unified": 0, "forward": 0, "traceback": 0, "clusters": {}}
    for (k, polys), force in ([(code, None) for code in WIDE_CODES]
                              + [(WIDE_CODES[0], 1), (WIDE_CODES[-1], 1)]):
        tr = make_trellis(k, polys)
        if not autotune.wide_mapping(tr):
            raise AssertionError(f"K={k} beta={tr.beta} is not a wide code")
        C = autotune.wide_cluster(tr, "cuda") if force is None else force
        if force is None and C != autotune.cluster_size(tr):
            log("parity", f"K={k}: the card holds no cluster of "
                f"{autotune.cluster_size(tr)} blocks; the device-memory "
                f"path runs it")
        counts["clusters"][f"K={k} beta={tr.beta}"
                           + (" forced" if force else "")] = C
        for spec in specs:
            frames = _frames(tr, spec, WIDE_PARITY_FRAMES, gen,
                             torch.float32)
            f0, v2s, start = _tb_geometry(spec)
            for pack in (False, True):
                for radix in (2, 4):
                    for bm in ("float32", "bfloat16"):
                        kw = dict(trellis=tr, v1=spec.v1, f=spec.f,
                                  v2=spec.v2, f0=f0, v2s=v2s, start=start,
                                  frames_per_tile=1, pack_survivors=pack,
                                  radix=radix, bm_dtype=bm)
                        what = f"k={k} beta={tr.beta} C={C} {spec} {kw}"
                        _check_equal(
                            vu.unified_decode_frames_cuda(
                                frames, _cluster=force, **kw),
                            vu.unified_decode_frames_plain(frames, **kw),
                            "wide unified " + what)
                        counts["unified"] += 1
                        for layout in ("lane", "sublane"):
                            fkw = dict(trellis=tr, frames_per_tile=1,
                                       pack_survivors=pack, radix=radix,
                                       layout=layout, bm_dtype=bm)
                            fwd = vf.forward_frames_cuda(
                                frames, _cluster=force, **fkw)
                            _check_equal(fwd,
                                         vf.forward_frames_plain(frames,
                                                                 **fkw),
                                         f"wide forward {layout} " + what)
                            counts["forward"] += 1
                            tkw = dict(trellis=tr, v1=spec.v1, f=spec.f,
                                       f0=f0, v2s=v2s, start=start,
                                       packed=pack, layout=layout)
                            _check_equal(
                                tbf.traceback_frames_cuda(*fwd, **tkw),
                                tbf.traceback_frames_plain(*fwd, **tkw),
                                f"wide traceback {layout} " + what)
                            counts["traceback"] += 1
            del frames
    return counts


def phase_blocked(gen):
    """The block-parallel decode (ops.py's reframe_blocks/merge_blocks) on
    the card: block_frames > 1 through both kernels equals the blocked
    plain decode on the CPU, and overlap >= full_overlap equals the
    unblocked decode. Returns a summary for the parity line."""
    import torch
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.trellis import STD_K7
    from repro_torch.kernels import block, ops
    spec = FrameSpec(f=2048, v1=20, v2=45, f0=32, v2s=45)
    frames = _frames(STD_K7, spec, 6, gen, torch.float32)
    full = block.full_overlap(spec, 4)
    for unified in (True, False):
        for layout in ("lane", "sublane"):
            kw = dict(unified=unified, layout=layout)
            for bf, ov in ((8, 45), (16, 64)):
                got = ops.viterbi_decode_frames(
                    frames, STD_K7, spec, device="cuda", block_frames=bf,
                    overlap=ov, **kw)
                want = ops.viterbi_decode_frames(
                    frames.cpu(), STD_K7, spec, device="cpu",
                    block_frames=bf, overlap=ov, **kw)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"blocked decode bf={bf} ov={ov} "
                                         f"{kw}: card != cpu")
            got = ops.viterbi_decode_frames(frames, STD_K7, spec,
                                            device="cuda", block_frames=4,
                                            overlap=full, **kw)
            if not torch.equal(got, ops.viterbi_decode_frames(
                    frames, STD_K7, spec, device="cuda", **kw)):
                raise AssertionError(f"blocked decode at full overlap "
                                     f"{full} {kw} != unblocked")
    return (f"blocked decode (K=7, f=2048, block_frames 8/16, overlap 45/64) "
            f"equal to the CPU's through both kernels and layouts, and at "
            f"overlap {full} (full_overlap, 4 blocks) equal to the "
            f"unblocked decode")


def main_config(rate: str, backend: str):
    """The paper's configuration at rate 1/2. Rate 3/4 needs f, v1, v2 in
    multiples of the puncturing period 3, so it takes the repo's rate-3/4
    receiver frame (examples/sdr_pipeline.py)."""
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.pipeline import DecoderConfig
    spec = (FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45) if rate == "1/2"
            else FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45))
    return DecoderConfig(spec=spec, rate=rate, backend=backend)


def _counters():
    from repro_torch.kernels import framing
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    return {"viterbi_unified": vu.unified_decode_frames_cuda,
            "viterbi_fwd": vf.forward_frames_cuda,
            "traceback_frames": tbf.traceback_frames_cuda,
            "frame_llr": framing.frame_llr_cuda,
            "frame_punctured": framing.frame_punctured_cuda}


def _drive(backend, streams):
    """Decode every stream through make_decoder(backend) with all launch
    counts set to 0 just before; returns (bits by rate, counts, wall)."""
    import torch
    from repro_torch.core.pipeline import make_decoder
    decoders = {rate: make_decoder(main_config(rate, backend), "cuda")
                for rate in streams}
    torch.cuda.synchronize()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    mapping = counters["viterbi_unified"].mapping_launches
    for m in mapping:
        mapping[m] = 0
    t0 = time.perf_counter()
    decoded = {rate: decoders[rate](rx, N_BITS)
               for rate, (_, rx) in streams.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    return decoded, counts, wall


def phase_main(gen):
    """Returns (launch counts by kernel on their own paths, the rate-1/2
    frames and received stream)."""
    import torch
    from repro_torch.channel.sim import ber, channel
    from repro_torch.core.framed import frame_llr
    from repro_torch.core.pipeline import make_decoder
    from repro_torch.core.puncture import depuncture

    streams = {rate: channel(gen, N_BITS, EBN0_DB, rate)
               for rate in ("1/2", "3/4")}
    unified, ucounts, uwall = _drive("kernel", streams)
    if ucounts["viterbi_unified"] < 1:
        raise AssertionError("the main path never launched viterbi_unified")
    mapping = dict(_counters()["viterbi_unified"].mapping_launches)
    if mapping["thread"] != ucounts["viterbi_unified"] or \
            sum(mapping.values()) != mapping["thread"]:
        raise AssertionError(f"the K=7 main path's B1 launches by mapping "
                             f"{mapping}: expected every one on the thread "
                             f"mapping")
    if (ucounts["frame_llr"], ucounts["frame_punctured"]) != (1, 1):
        raise AssertionError(f"kernel path launches {ucounts}: expected one "
                             f"frame_llr launch at rate 1/2 and one "
                             f"frame_punctured launch at rate 3/4")
    split, scounts, swall = _drive("kernel_split", streams)
    want = {"viterbi_unified": 0, "viterbi_fwd": 2, "traceback_frames": 2,
            "frame_llr": 1, "frame_punctured": 1}
    if scounts != want:
        raise AssertionError(f"split path launches {scounts}, expected "
                             f"{want} (one forward, one traceback and one "
                             f"framing launch per call, no unified launch)")
    framing_fns = [_counters()[k] for k in ("frame_llr", "frame_punctured")]
    for rate, (bits, rx) in streams.items():
        before = [fn.launches for fn in framing_fns]
        ref = make_decoder(main_config(rate, "reference"), "cuda")(rx, N_BITS)
        if [fn.launches for fn in framing_fns] != before:
            raise AssertionError(f"rate {rate}: the reference backend "
                                 f"launched the framing kernel")
        for name, out in (("kernel", unified[rate]),
                          ("kernel_split", split[rate])):
            if not (out.shape == (N_BITS,) and out.dtype == torch.int32):
                raise AssertionError(f"rate {rate} {name}: bad output "
                                     f"{out.shape} {out.dtype}")
            if not torch.equal(out, ref):
                raise AssertionError(f"rate {rate}: {name} != reference")
        if not torch.equal(split[rate], unified[rate]):
            raise AssertionError(f"rate {rate}: kernel_split != kernel")
        b = ber(unified[rate], bits)
        log("main", f"rate {rate}: n={N_BITS} Eb/N0={EBN0_DB} dB BER={b:.3e}; "
            f"kernel and kernel_split equal to the reference backend")
        if rate == "1/2" and not b < BER_LIMIT:
            raise AssertionError(f"rate 1/2 BER {b} >= {BER_LIMIT}")
    log("main", f"backend=kernel B1 launches by mapping {mapping}")
    log("main", f"backend=kernel launches {ucounts}, both rates in "
        f"{uwall * 1e3:.1f} ms; backend=kernel_split launches {scounts}, "
        f"both rates in {swall * 1e3:.1f} ms (host clock, after synchronize, "
        f"first calls)")
    rx = streams["1/2"][1]
    spec = main_config("1/2", "kernel").spec
    frames = frame_llr(depuncture(rx, "1/2", N_BITS), spec).contiguous()
    launches = {"viterbi_unified": ucounts["viterbi_unified"],
                "viterbi_fwd": scounts["viterbi_fwd"],
                "traceback_frames": scounts["traceback_frames"],
                "frame_llr": ucounts["frame_llr"],
                "frame_punctured": ucounts["frame_punctured"]}
    return launches, frames, rx


def wide_config(backend: str):
    """The wide main path's configuration: the K=16 rate-1/2 code of
    WIDE_CODES at the paper's frame."""
    import dataclasses
    from repro_torch.core.trellis import make_trellis
    return dataclasses.replace(main_config("1/2", backend),
                               trellis=make_trellis(*WIDE_CODES[0]))


def large_config(backend: str):
    """The large codes' main path's configuration: Galileo's K=15 rate-1/4
    code (CODES[9]) at the paper's frame, unpunctured."""
    import dataclasses
    from repro_torch.core.trellis import make_trellis
    return dataclasses.replace(main_config("1/2", backend),
                               trellis=make_trellis(*CODES[9]))


def _code_path(config, rx, n, label):
    """``rx`` through make_decoder(config(backend)) for backend "kernel",
    then "kernel_split", the launch counts set to 0 just before each call
    and read just after; both equal to the reference backend's bits, B1
    launched once by the first and B3 and the traceback once each by the
    second, the framing kernel once by each. Returns (the reference bits,
    {kernel: launches} of the backend that runs it, first-call walls by
    backend)."""
    import torch
    from repro_torch.core.pipeline import make_decoder
    ref = make_decoder(config("reference"), "cuda")(rx, n)
    counters = _counters()
    counts, walls = {}, {}
    for backend in ("kernel", "kernel_split"):
        decode = make_decoder(config(backend), "cuda")
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = decode(rx, n)
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - t0
        counts[backend] = {name: fn.launches
                           for name, fn in counters.items()}
        if not (out.shape == (n,) and out.dtype == torch.int32):
            raise AssertionError(f"{label} {backend}: bad output {out.shape} "
                                 f"{out.dtype}")
        if not torch.equal(out, ref):
            raise AssertionError(f"{label} {backend} != reference backend")
    want = {"kernel": {"viterbi_unified": 1, "viterbi_fwd": 0,
                       "traceback_frames": 0, "frame_llr": 1,
                       "frame_punctured": 0},
            "kernel_split": {"viterbi_unified": 0, "viterbi_fwd": 1,
                             "traceback_frames": 1, "frame_llr": 1,
                             "frame_punctured": 0}}
    if counts != want:
        raise AssertionError(f"{label} launches {counts}, expected {want}")
    return ref, {"viterbi_unified": counts["kernel"]["viterbi_unified"],
                 "viterbi_fwd": counts["kernel_split"]["viterbi_fwd"],
                 "traceback_frames": counts["kernel_split"][
                     "traceback_frames"],
                 "frame_llr": counts["kernel"]["frame_llr"],
                 "frame_punctured": counts["kernel"]["frame_punctured"]}, \
        counts, walls


def phase_main_wide(gen):
    """The wide mapping's main path: WIDE_MAIN_FRAMES frames of K=16 rate
    1/2 through make_decoder(backend="kernel"), then "kernel_split", the
    launch counts set to 0 just before each and read just after; the bits
    equal the reference backend's. Returns {kernel: launches} of the
    backend that runs it."""
    from repro_torch.channel.sim import ber, channel
    from repro_torch.kernels import autotune
    tr = wide_config("kernel").trellis
    n = WIDE_MAIN_FRAMES * wide_config("kernel").spec.f
    bits, rx = channel(gen, n, EBN0_DB, "1/2", trellis=tr)
    ref, launches, counts, walls = _code_path(wide_config, rx, n, "K=16")
    log("main", f"K=16 rate 1/2 (wide mapping, a cluster of "
        f"{autotune.wide_cluster(tr, 'cuda')} blocks a frame): n={n} "
        f"({WIDE_MAIN_FRAMES} "
        f"frames of f=256) Eb/N0={EBN0_DB} dB BER={ber(ref, bits):.3e}; "
        f"kernel and kernel_split equal to the reference backend; launches "
        f"{counts}; first calls {walls['kernel'] * 1e3:.1f} ms / "
        f"{walls['kernel_split'] * 1e3:.1f} ms (host clock, after "
        f"synchronize)")
    return launches


def phase_main_large(gen):
    """The large codes' main path: LARGE_MAIN_FRAMES frames of Galileo's
    K=15 rate-1/4 code (the one-block form, one block a frame on the blocks
    resident at once) through make_decoder(backend="kernel"), then
    "kernel_split", the launch counts set to 0 just before each and read
    just after; the bits equal the reference backend's. The received
    stream is the codeword's (n, 4) symbols through the AWGN channel at
    LARGE_MAIN_EBN0_DB. Returns {kernel: launches} of the backend that
    runs it."""
    from repro_torch.channel.sim import awgn, ber, bpsk
    from repro_torch.core.encoder import encode
    from repro_torch.kernels import autotune
    import torch
    tr = large_config("kernel").trellis
    n = LARGE_MAIN_FRAMES * large_config("kernel").spec.f
    bits = torch.randint(0, 2, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rx = awgn(bpsk(encode(bits, tr)), LARGE_MAIN_EBN0_DB, gen)   # (n, 4)
    ref, launches, counts, walls = _code_path(large_config, rx, n,
                                              "Galileo K=15")
    log("main", f"Galileo K=15 rate 1/4 (one-block form: "
        f"{autotune.large_threads(tr)} threads a frame, "
        f"{autotune.block_grid(tr, LARGE_MAIN_FRAMES, 'cuda')} blocks "
        f"launched): n={n} ({LARGE_MAIN_FRAMES} frames of f=256) "
        f"Eb/N0={LARGE_MAIN_EBN0_DB} dB BER={ber(ref, bits):.3e}; kernel "
        f"and kernel_split equal to the reference backend; launches "
        f"{counts}; first calls {walls['kernel'] * 1e3:.1f} ms / "
        f"{walls['kernel_split'] * 1e3:.1f} ms (host clock, after "
        f"synchronize)")
    return launches


def lowrate_config(backend: str):
    """The low rates' main path's configuration: the K=7 rate-1/9 code of
    LOW_RATE_CODES at the paper's frame, unpunctured."""
    import dataclasses
    from repro_torch.core.trellis import make_trellis
    return dataclasses.replace(main_config("1/2", backend),
                               trellis=make_trellis(*LOW_RATE_CODES[1]))


def phase_main_lowrate(gen):
    """The low rates' main path: LOWRATE_MAIN_FRAMES frames of K=7 rate 1/9
    (the register mapping with beta at run time) through
    make_decoder(backend="kernel"), then "kernel_split", the launch counts
    set to 0 just before each and read just after; the bits equal the
    reference backend's. The received stream is the codeword's (n, 9)
    symbols through the AWGN channel at LOWRATE_MAIN_EBN0_DB. Returns
    {kernel: launches} of the backend that runs it."""
    from repro_torch.channel.sim import awgn, ber, bpsk
    from repro_torch.core.encoder import encode
    from repro_torch.kernels import autotune
    import torch
    tr = lowrate_config("kernel").trellis
    if autotune.wide_mapping(tr) or not autotune.low_rate(tr):
        raise AssertionError(f"K={tr.k} beta={tr.beta} is not a low-rate "
                             f"code on the fast mappings")
    n = LOWRATE_MAIN_FRAMES * lowrate_config("kernel").spec.f
    bits = torch.randint(0, 2, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rx = awgn(bpsk(encode(bits, tr)), LOWRATE_MAIN_EBN0_DB, gen)  # (n, 9)
    ref, launches, counts, walls = _code_path(lowrate_config, rx, n,
                                              "K=7 rate 1/9")
    log("main", f"K=7 rate 1/9 (register mapping, beta at run time): "
        f"n={n} ({LOWRATE_MAIN_FRAMES} frames of f=256) "
        f"Eb/N0={LOWRATE_MAIN_EBN0_DB} dB BER={ber(ref, bits):.3e}; kernel "
        f"and kernel_split equal to the reference backend; launches "
        f"{counts}; first calls {walls['kernel'] * 1e3:.1f} ms / "
        f"{walls['kernel_split'] * 1e3:.1f} ms (host clock, after "
        f"synchronize)")
    return launches


def _interleaved(fns: dict, reps: int, rounds: int = 2) -> dict:
    """Min ms per call of each fn, timed in turns a, b, ..., b, a."""
    best = {k: float("inf") for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            best[k] = min(best[k], cuda_ms(fns[k], reps))
    return best


def time_unified(frames, launches):
    import torch
    from repro_torch.core.trellis import STD_K7
    from repro_torch.kernels import autotune
    from repro_torch.kernels import viterbi_unified as vu

    F, L, beta = frames.shape
    spec = main_config("1/2", "kernel").spec
    auto = autotune.plan_tiles(STD_K7, spec, pack_survivors=True, radix=4,
                               max_frames=F, device="cuda")
    kw = dict(trellis=STD_K7, v1=20, f=256, v2=45, f0=32, v2s=45,
              frames_per_tile=auto.frames_per_tile, pack_survivors=True,
              radix=4)
    got = vu.unified_decode_frames_cuda(frames, **kw)
    want = None

    def plain():
        nonlocal want
        want = vu.unified_decode_frames_plain(frames, **kw)
    plain_ms = host_ms(plain)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError("main-shape unified kernel != plain version")
    for _ in range(3):                                   # warm-up
        vu.unified_decode_frames_cuda(frames, **kw)
    tiles = _interleaved({
        ft: (lambda ft=ft: vu.unified_decode_frames_cuda(
            frames, **dict(kw, frames_per_tile=ft)))
        for ft in dict.fromkeys((auto.frames_per_tile, 4))}, 20, rounds=4)
    ms = tiles[auto.frames_per_tile]
    if ms > tiles[4] * (1 + AUTO_TILE_SLACK):
        raise AssertionError(f"auto tile {auto.frames_per_tile} takes "
                             f"{ms:.4f} ms, more than {AUTO_TILE_SLACK:.0%} "
                             f"over tile 4's {tiles[4]:.4f} ms")
    log("time", f"viterbi_unified auto tile {auto.frames_per_tile} "
        f"({auto.frames_per_sm} resident frames/SM predicted, "
        f"{auto.registers} registers, {auto.smem_bytes} B smem/block) "
        f"{ms:.4f} ms vs tile 4 {tiles[4]:.4f} ms "
        f"({(ms / tiles[4] - 1) * 100:+.2f} %, limit "
        f"+{AUTO_TILE_SLACK:.0%}); limits {autotune.device_limits('cuda')}")
    sweep = {}
    for name, knobs in [(f"tile{ft}", dict(frames_per_tile=ft))
                        for ft in autotune.candidate_tiles(STD_K7)] + [
            ("unpacked", dict(pack_survivors=False)),
            ("radix2", dict(radix=2)),
            ("bf16_bm", dict(bm_dtype="bfloat16")),
            ("serial_tb", dict(f0=256, v2s=45))]:
        kt = dict(kw, **knobs)
        vu.unified_decode_frames_cuda(frames, **kt)
        sweep[name] = round(cuda_ms(
            lambda: vu.unified_decode_frames_cuda(frames, **kt), 10), 4)
    bound_ms, bound_by, _ = bound("viterbi_unified", spec, F,
                                  llr_bytes=frames.element_size())
    log("time", f"viterbi_unified F={F} L={L}: {ms * 1e3:.1f} us/launch "
        f"({F * 256 / ms / 1e3:.1f} Mb/s); plain version {plain_ms:.1f} ms "
        f"(host clock, once); bound {bound_ms * 1e3:.1f} us ({bound_by})")
    log("time", f"ms per launch by knob (auto tile "
        f"{auto.frames_per_tile} unless named; packed, radix 4, f32 bm, "
        f"parallel traceback): {sweep}")
    thread_vs_warp(frames)
    return {"name": "viterbi_unified", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/viterbi_unified.cu",
            "replaces": "src/repro/kernels/viterbi_unified.py:199",
            "launches": launches["viterbi_unified"], "max_abs_err": err,
            "parity": "equal", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


#: B1 at K=7 on the thread mapping against the warp mapping: the main
#: shape, the K=7 cells' calls, and the launches of the stream's default
#: chunk, of the server's full batch and at the card's threshold (code,
#: frames, frame geometry).
THREAD_ROWS = [("main", CODES[4], 16384,
                dict(v1=20, f=256, v2=45, f0=32, v2s=45)),
               ("k7_r12_batch", CODES[4], 65536,
                dict(v1=20, f=256, v2=45, f0=32, v2s=45)),
               ("k7_r34_batch", (7, (0o133, 0o171)), 66624,
                dict(v1=21, f=252, v2=45, f0=42, v2s=45)),
               ("stream chunk", CODES[4], 64,
                dict(v1=20, f=256, v2=45, f0=32, v2s=45)),
               ("serve batch", CODES[4], 4096,
                dict(v1=20, f=256, v2=45, f0=32, v2s=45)),
               ("threshold", CODES[4], 8448,
                dict(v1=20, f=256, v2=45, f0=32, v2s=45))]
#: The warp mapping's tile at K=7 (the planner's before the thread
#: mapping took K=7) and the thread mapping's (one warp of frames).
WARP_TILE = 2
THREAD_TILE = 32


def thread_vs_warp(main_frames):
    """B1 forced onto the thread mapping (``_thread``) against the warp
    mapping (``_warp``), in turns, at THREAD_ROWS, beside the mapping the
    launch takes unforced (``autotune.b1_mapping`` by its frame count);
    the bits equal."""
    import torch
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import viterbi_unified as vu
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for label, code, F, geometry in THREAD_ROWS:
        tr = make_trellis(*code)
        spec = FrameSpec(**geometry)
        frames = (main_frames if label == "main" else
                  _frames(tr, spec, F, gen, torch.float32))
        plan = autotune.plan_tiles(tr, spec, pack_survivors=True, radix=4,
                                   max_frames=F, device="cuda")
        takes = autotune.b1_mapping(tr, frames=F, device="cuda")
        kw = dict(geometry, trellis=tr, pack_survivors=True, radix=4)
        fns = {"thread": lambda: vu.unified_decode_frames_cuda(
                   frames, frames_per_tile=THREAD_TILE, _thread=True, **kw),
               "warp": lambda: vu.unified_decode_frames_cuda(
                   frames, frames_per_tile=WARP_TILE, _warp=True, **kw)}
        if not torch.equal(fns["thread"](), fns["warp"]()):
            raise AssertionError(f"{label}: the thread mapping != the warp "
                                 f"mapping")
        ms = _interleaved(fns, 5, rounds=4)
        log("time", f"viterbi_unified K=7 {label} F={F} (polys "
            f"{tuple(oct(g) for g in code[1])}): thread mapping tile "
            f"{THREAD_TILE} {ms['thread']:.4f} ms vs warp mapping tile "
            f"{WARP_TILE} {ms['warp']:.4f} ms "
            f"({ms['thread'] / ms['warp'] - 1:+.1%}; min of 4 rounds of 5, "
            f"in turns); unforced the launch takes the {takes} mapping "
            f"(planned tile {plan.frames_per_tile}, {plan.registers} "
            f"registers, {plan.frames_per_sm} resident frames/SM)")
        if label != "main":
            del frames


def time_split(frames, launches):
    """B3 and the traceback kernel at the main shape, both layouts."""
    import torch
    from repro_torch.core.trellis import STD_K7
    from repro_torch.kernels import autotune
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf

    F = frames.shape[0]
    spec = main_config("1/2", "kernel_split").spec
    plan = autotune.plan_tiles(STD_K7, spec, pack_survivors=True, radix=4,
                               unified=False, max_frames=F, device="cuda")
    ft = plan.frames_per_tile
    entries, by_layout = {}, {}
    for layout in ("lane", "sublane"):
        fkw = dict(trellis=STD_K7, frames_per_tile=ft, pack_survivors=True,
                   radix=4, layout=layout)
        tkw = dict(trellis=STD_K7, v1=20, f=256, f0=32, v2s=45,
                   packed=True, layout=layout)
        sel, amax = vf.forward_frames_cuda(frames, **fkw)
        bits = tbf.traceback_frames_cuda(sel, amax, **tkw)
        plain = {}
        fplain_ms = host_ms(lambda: plain.__setitem__(
            "fwd", vf.forward_frames_plain(frames, **fkw)))
        tplain_ms = host_ms(lambda: plain.__setitem__(
            "tb", tbf.traceback_frames_plain(sel, amax, **tkw)))
        ferr = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip((sel, amax), plain["fwd"]))
        terr = int((bits - plain["tb"]).abs().max())
        if ferr or terr:
            raise AssertionError(f"main-shape split kernels != plain "
                                 f"({layout}): {ferr} {terr}")
        best = _interleaved({
            "fwd": lambda: vf.forward_frames_cuda(frames, **fkw),
            "tb": lambda: tbf.traceback_frames_cuda(sel, amax, **tkw)},
            10)
        by_layout[layout] = best
        fb = bound("viterbi_fwd", spec, F, llr_bytes=frames.element_size())
        tb = bound("traceback_frames", spec, F)
        fbytes, tbytes = fb[2], tb[2]
        log("time", f"split {layout} tile {ft} ({plan.frames_per_sm} "
            f"resident frames/SM predicted, {plan.registers} registers): "
            f"viterbi_fwd "
            f"{best['fwd'] * 1e3:.1f} us (bound {fb[0] * 1e3:.1f} us "
            f"{fb[1]}: {fbytes / 1e6:.1f} MB; plain {fplain_ms:.1f} ms); "
            f"traceback_frames {best['tb'] * 1e3:.1f} us (bound "
            f"{tb[0] * 1e3:.1f} us {tb[1]}: {tbytes / 1e6:.1f} MB; plain "
            f"{tplain_ms:.1f} ms)")
        if layout == "lane":                 # the main path's layout
            entries["fwd"] = {
                "name": "viterbi_fwd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/viterbi_fwd.cu",
                "replaces": "src/repro/kernels/viterbi_fwd.py:114",
                "launches": launches["viterbi_fwd"], "max_abs_err": ferr,
                "parity": "equal", "ms": best["fwd"], "plain_ms": fplain_ms,
                "bound_ms": fb[0], "bound_by": fb[1], "library_ms": None}
            entries["tb"] = {
                "name": "traceback_frames", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/traceback_frames.cu",
                "replaces": "src/repro/core/traceback.py:160 (XLA scan, "
                            "not a pallas_call)",
                "launches": launches["traceback_frames"],
                "max_abs_err": terr, "parity": "equal", "ms": best["tb"],
                "plain_ms": tplain_ms, "bound_ms": tb[0], "bound_by": tb[1],
                "library_ms": None}
    entries["tb"]["modes"] = time_traceback_modes(frames, ft)
    return entries


#: Frames of the K=11 traceback timings (an unpacked K=11 stream is
#: L * 1024 bytes a frame).
TB_K11_FRAMES = 4096
#: The traceback shapes timed in turns, here (the two chases against each
#: other) and by tools/parent_turns.py (against another checkout): label,
#: code, layout, packed, f0 (256 = the serial chase). K=7 runs on the main
#: path's frames at the split plan's tile, K=11 on TB_K11_FRAMES frames at
#: tile 1.
TB_CASES = [("K7 lane packed", CODES[4], "lane", True, 32),
            ("K7 sublane packed", CODES[4], "sublane", True, 32),
            ("K7 lane unpacked", CODES[4], "lane", False, 32),
            ("K7 lane packed serial", CODES[4], "lane", True, 256),
            ("K11 lane packed", CODES[6], "lane", True, 32),
            ("K11 lane unpacked", CODES[6], "lane", False, 32),
            ("K11 sublane packed", CODES[6], "sublane", True, 32)]


def time_traceback_modes(frames, ft):
    """The traceback kernel's two chases (staged in shared memory, direct
    from device memory) and the shape rule's pick, timed in turns on the
    forward kernel's streams at the TB_CASES shapes. A mode whose block
    does not fit shared memory is not timed. Every launch's bits equal the
    rule's. Returns {case: {mode: ms}}."""
    import torch
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    spec = main_config("1/2", "kernel_split").spec
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    frames11 = _frames(make_trellis(*CODES[6]), spec, TB_K11_FRAMES, gen,
                       torch.float32)
    v2s = 45
    out = {}
    for label, code, layout, pack, f0 in TB_CASES:
        tr = make_trellis(*code)
        fr, tile = (frames, ft) if code == CODES[4] else (frames11, 1)
        sel, amax = vf.forward_frames_cuda(fr, trellis=tr,
                                           frames_per_tile=tile,
                                           pack_survivors=pack, radix=4,
                                           layout=layout)
        tkw = dict(trellis=tr, v1=20, f=256, f0=f0, v2s=v2s, packed=pack,
                   layout=layout)
        plan = tbf.chase_plan(tr, L=spec.frame_len, f=256, f0=f0, v2s=v2s,
                              F=fr.shape[0], packed=pack, layout=layout)
        want = tbf.traceback_frames_cuda(sel, amax, **tkw)
        fns = {}
        for chase in ("staged", "direct"):
            try:
                got = tbf.traceback_frames_cuda(sel, amax, chase=chase, **tkw)
            except ValueError:               # the block does not fit
                continue
            _check_equal(got, want, f"traceback {chase} {label}")
            fns[chase] = (lambda c=chase: tbf.traceback_frames_cuda(
                sel, amax, chase=c, **tkw))
        ms = _interleaved(fns, 10, rounds=4)
        tb = bound("traceback_frames",
                   dataclasses.replace(spec, f0=f0, v2s=v2s), fr.shape[0],
                   trellis=tr, pack_survivors=pack)
        pick = "staged" if plan.staged else "direct"
        log("time", f"traceback {label} F={fr.shape[0]}: rule picks {pick} "
            f"({plan.frames} frames, {plan.threads} threads, "
            f"{plan.smem_bytes} B a block): "
            + ", ".join(f"{m} {v * 1e3:.1f} us" for m, v in ms.items())
            + f" (in turns, min of 4 rounds of 10); bound "
            f"{tb[0] * 1e3:.1f} us ({tb[1]}, {tb[0] / ms[pick]:.1%})")
        out[label] = {"rule": pick, **{m: round(v, 5) for m, v in ms.items()}}
        del sel, amax
    return out


def time_large_codes(gen):
    """B1 and B3 at the large codes (K=12, K=13, the Galileo K=15 code,
    K=14, K=12 beta=8) on the main path's frame, packed, radix 4, at
    LARGE_TIME_FRAMES and, for K=12 and K=15, at LARGE_FULL_FRAMES: bits
    and streams equal the plain versions (at LARGE_TIME_FRAMES); ms per
    launch beside the bound (CUDA events), with the one-block form's
    threads, the blocks launched and resident an SM, and where B1 keeps
    its survivors. Returns {name: [{k, beta, F, threads, grid, ms,
    bound_ms, bound_by}, ...]}."""
    import torch
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    spec = main_config("1/2", "kernel").spec
    out = {"viterbi_unified": [], "viterbi_fwd": []}
    kw = dict(v1=20, f=256, v2=45, f0=32, v2s=45, frames_per_tile=1,
              pack_survivors=True, radix=4)
    fkw = dict(frames_per_tile=1, pack_survivors=True, radix=4)
    for code in CODES:
        if code[0] < LARGE_K:
            continue
        tr = make_trellis(*code)
        kw["trellis"] = fkw["trellis"] = tr
        base = _frames(tr, spec, LARGE_TIME_FRAMES[tr.k], gen, torch.float32)
        want = (vu.unified_decode_frames_plain(base, **kw),
                vf.forward_frames_plain(base, **fkw))
        for F in (LARGE_TIME_FRAMES[tr.k],) + (
                (LARGE_FULL_FRAMES,) if code in (CODES[7], CODES[9]) else ()):
            # the base frames again and again: blocks that take several
            # frames in turn must give each the base frame's outputs
            reps = F // base.shape[0]
            frames = base.repeat(reps, 1, 1)
            _check_equal(vu.unified_decode_frames_cuda(frames, **kw),
                         want[0].repeat(reps, 1),
                         f"unified k={tr.k} main frame F={F}")
            _check_equal(vf.forward_frames_cuda(frames, **fkw),
                         tuple(w.repeat(reps, 1, 1) if w.ndim == 3
                               else w.repeat(reps, 1) for w in want[1]),
                         f"forward k={tr.k} main frame F={F}")
            ms = _interleaved({
                "viterbi_unified": lambda: vu.unified_decode_frames_cuda(
                    frames, **kw),
                "viterbi_fwd": lambda: vf.forward_frames_cuda(frames,
                                                              **fkw)},
                3, rounds=2)
            plans = {name: autotune.plan_tiles(
                tr, spec, pack_survivors=True, max_frames=F,
                unified=name == "viterbi_unified", device="cuda")
                for name in out}
            T = autotune.large_threads(tr)
            for name in out:
                b = bound(name, spec, F, trellis=tr)
                grid = min(F, plans[name].frames_per_sm
                           * torch.cuda.get_device_properties(0)
                           .multi_processor_count)
                out[name].append({"k": tr.k, "beta": tr.beta, "F": F,
                                  "threads": T, "grid": grid,
                                  "ms": ms[name], "bound_ms": b[0],
                                  "bound_by": b[1]})
            pu = plans["viterbi_unified"]
            where = ("in device scratch"
                     if dict(pu.breakdown)["sel_survivors"] == 0
                     else "on chip")
            log("time", f"large code K={tr.k} beta={tr.beta} F={F} L="
                f"{spec.frame_len} (one-block form: {T} threads of "
                f"{tr.num_states // 2 // T} butterflies a frame; B1 "
                f"{pu.smem_bytes} B smem, survivors {where}, "
                f"{pu.frames_per_sm} blocks an SM, {pu.registers} registers;"
                f" B3 {plans['viterbi_fwd'].smem_bytes} B smem, "
                f"{plans['viterbi_fwd'].frames_per_sm} blocks an SM, "
                f"{plans['viterbi_fwd'].registers} registers): "
                + "; ".join(f"{n} {ms[n]:.4f} ms, bound "
                            f"{out[n][-1]['bound_ms']:.4f} ms "
                            f"({out[n][-1]['bound_by']}, "
                            f"{out[n][-1]['bound_ms'] / ms[n]:.1%})"
                            for n in out))
            del frames
        del base, want
    return out


def time_wide_codes(gen):
    """B1, B3 and the traceback on the wide mapping and at the low rates
    (WIDE_TIME: K=16, 17, 18 and 19 at rate 1/2 on clusters; K=7 at rates
    1/9 and 1/16, K=11 rate 1/9 on the register mapping at run-time beta,
    K=13 and 15 rate 1/9 on the one-block form's per-edge sums) at the main
    frame, packed, radix 4, lane, the planner's tiles: each equal to its
    plain version, then ms per launch in turns (CUDA events) beside the
    plain version's (host clock, once) and the bound, with the mapping:
    the cluster (C blocks a frame), the clusters launched and resident and
    each block's shared memory; or the tile or threads, the frames
    resident an SM, the registers. Returns {name: [{k, beta, F, mapping,
    cluster, grid, ms, plain_ms, bound_ms, bound_by}, ...]}."""
    import torch
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    spec = main_config("1/2", "kernel").spec
    names = ("viterbi_unified", "viterbi_fwd", "traceback_frames")
    out = {n: [] for n in names}
    for code, F in WIDE_TIME:
        tr = make_trellis(*code)
        frames = _frames(tr, spec, F, gen, torch.float32)
        plans = {u: autotune.plan_tiles(tr, spec, pack_survivors=True,
                                        radix=4, unified=u, max_frames=F,
                                        device="cuda")
                 for u in (True, False)}
        kw = dict(trellis=tr, v1=20, f=256, v2=45, f0=32, v2s=45,
                  frames_per_tile=plans[True].frames_per_tile,
                  pack_survivors=True, radix=4)
        fkw = dict(trellis=tr, frames_per_tile=plans[False].frames_per_tile,
                   pack_survivors=True, radix=4)
        tkw = dict(trellis=tr, v1=20, f=256, f0=32, v2s=45, packed=True)
        # the plain versions keep every stage's (F, S) survivors and
        # (F, half) branch metrics: past k = 17 or beta = 13 they run
        # PLAIN_WIDE_BYTES of them at a time, frames being independent
        half = 1 << (tr.beta - 1)
        n = max(1, PLAIN_WIDE_BYTES // (spec.frame_len
                                        * (tr.num_states + half) * 8))

        def chunked(fn, *xs):
            parts = [fn(*(x[i:i + n] for x in xs))
                     for i in range(0, F, n)]
            if isinstance(parts[0], tuple):
                return tuple(torch.cat(p) for p in zip(*parts))
            return torch.cat(parts)

        plain = {}
        plain_ms = {
            "viterbi_unified": host_ms(lambda: plain.__setitem__(
                "viterbi_unified", chunked(
                    lambda x: vu.unified_decode_frames_plain(x, **kw),
                    frames))),
            "viterbi_fwd": host_ms(lambda: plain.__setitem__(
                "viterbi_fwd", chunked(
                    lambda x: vf.forward_frames_plain(x, **fkw), frames)))}
        sel, amax = vf.forward_frames_cuda(frames, **fkw)
        plain_ms["traceback_frames"] = host_ms(lambda: plain.__setitem__(
            "traceback_frames", chunked(
                lambda a, b: tbf.traceback_frames_plain(a, b, **tkw),
                sel, amax)))
        _check_equal(vu.unified_decode_frames_cuda(frames, **kw),
                     plain["viterbi_unified"], f"wide unified k={tr.k}")
        _check_equal((sel, amax), plain["viterbi_fwd"],
                     f"wide forward k={tr.k}")
        _check_equal(tbf.traceback_frames_cuda(sel, amax, **tkw),
                     plain["traceback_frames"], f"wide traceback k={tr.k}")
        del plain
        ms = _interleaved({
            "viterbi_unified": lambda: vu.unified_decode_frames_cuda(
                frames, **kw),
            "viterbi_fwd": lambda: vf.forward_frames_cuda(frames, **fkw),
            "traceback_frames": lambda: tbf.traceback_frames_cuda(
                sel, amax, **tkw)}, 3, rounds=2)
        plan = plans[True]
        C = autotune.wide_cluster(tr, "cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if autotune.wide_mapping(tr):
            mapping = f"cluster of {C}" if C > 1 else "wide"
            grid = autotune.wide_grid(tr, F, "cuda")
            resident = (autotune.cluster_capacity(tr, C, "cuda") if C > 1
                        else autotune.wide_grid(tr, 1 << 30, "cuda"))
            where = (f"cluster C={C}: {grid} clusters launched, {resident} "
                     f"resident, {autotune.cluster_threads(tr, C)} threads "
                     f"and {plan.smem_bytes} B smem a block, path metrics "
                     f"in the cluster's shared memory" if C > 1 else
                     f"no cluster: {grid} blocks launched, {resident} "
                     f"resident, {autotune.wide_threads(tr)} threads and "
                     f"{plan.smem_bytes} B smem a block, path metrics "
                     f"in device memory")
        elif autotune.smem_mapping(tr):
            mapping = "one-block per-edge"
            grid = min(F, plan.frames_per_sm * sms)
            T = autotune.large_threads(tr)
            where = (f"one-block form, per-edge sums: {T} threads of "
                     f"{tr.num_states // 2 // T} butterflies, {grid} blocks "
                     f"launched, B1 {plan.frames_per_sm} / B3 "
                     f"{plans[False].frames_per_sm} blocks an SM, B1 "
                     f"{plan.smem_bytes} B smem")
        else:
            mapping = "register run-time beta"
            grid = -(-F // plan.frames_per_tile)
            b3 = plans[False]
            b3_grid = (autotune.wide_grid(tr, F, "cuda", unified=False,
                                          cluster=1)
                       if autotune.wide_mapping(tr, unified=False) else 0)
            where = (f"register mapping at run-time beta: B1 tile "
                     f"{plan.frames_per_tile} ({grid} blocks), "
                     f"{plan.frames_per_sm} frames an SM, {plan.smem_bytes} "
                     f"B smem; B3 "
                     + (f"on the wide mapping, {b3_grid} blocks launched"
                        if b3_grid else f"tile {b3.frames_per_tile}")
                     + f", {b3.frames_per_sm} frames an SM, "
                     f"{b3.registers} registers; LLR chunks "
                     f"{autotune.llr_chunk_bytes(tr)} B a warp")
        for name in names:
            b = bound(name, spec, F, trellis=tr)
            out[name].append({"k": tr.k, "beta": tr.beta, "F": F,
                              "mapping": mapping, "cluster": C,
                              "grid": grid, "ms": ms[name],
                              "plain_ms": plain_ms[name],
                              "bound_ms": b[0], "bound_by": b[1]})
        log("time", f"{mapping} K={tr.k} beta={tr.beta} F={F} L="
            f"{spec.frame_len} ({where}, {plan.registers} registers): "
            + "; ".join(f"{n} {ms[n]:.4f} ms, plain {plain_ms[n]:.1f} ms, "
                        f"bound {out[n][-1]['bound_ms']:.4f} ms "
                        f"({out[n][-1]['bound_by']}, "
                        f"{out[n][-1]['bound_ms'] / ms[n]:.1%})"
                        for n in names))
        del frames, sel, amax
    return out


#: The benchmark cells' calls of the framing kernel: (cell, n, beta, clip)
#: at the main frame in float32 (k7_r12_mesh4 frames on its home card).
FRAMING_CELLS = [("k7_r12_batch", 1 << 24, 2, True),
                 ("k7_r12_mesh4", 1 << 26, 2, False),
                 ("galileo_k15_batch", 1 << 20, 4, True)]
#: The values planted in the framing kernel's LLRs.
FRAMING_PLANTED = [float("nan"), float("inf"), -float("inf"), 2e6, -2e6,
                   1e6, -1e6, -0.0]


def _framing_row(x, clip: bool):
    """The framing kernel on (n, beta) float32 LLRs ``x`` at the main frame,
    a few thousand of them poisoned: bit for bit against its plain
    version, then both timed in turns (min of 4 rounds of 20 launches,
    CUDA events), beside the bytes bound."""
    import torch
    from repro_torch.core.sanitize import LLR_CLIP
    from repro_torch.kernels import framing
    from repro_torch.launch.roofline import kernel_bound
    spec = main_config("1/2", "kernel").spec
    n, beta = x.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    idx = torch.randint(0, x.numel(), (4096,), generator=gen, device="cuda")
    poison = torch.tensor(FRAMING_PLANTED, device="cuda")
    x.view(-1)[idx] = poison[torch.arange(idx.numel(), device="cuda")
                             % poison.numel()]
    c = LLR_CLIP if clip else None
    got = framing.frame_llr_cuda(x, spec, c)
    want = framing.frame_llr_plain(x, spec, c)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"frame_llr ({n}, {beta}) clip={clip}: kernel "
                             f"!= plain version")
    del got, want
    ms = _interleaved({"kernel": lambda: framing.frame_llr_cuda(x, spec, c),
                       "plain": lambda: framing.frame_llr_plain(x, spec, c)},
                      20, rounds=4)
    nbytes = (x.numel() + spec.num_frames(n) * spec.frame_len * beta) * 4
    bound_ms, bound_by = kernel_bound(nbytes, 0)
    return {"n": n, "beta": beta, "clip": clip, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes}


def _framing_line(what, r):
    return (f"{what} ({r['n']}, {r['beta']}) clip "
            f"{'on' if r['clip'] else 'off'}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.1f}x), bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB; "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound, "
            f"{r['bytes'] / r['ms'] / 1e6:.0f} GB/s)")


#: The benchmark cell of the punctured framing kernel: (cell, n, rate, B1's
#: tile), float32 at the rate-3/4 frame.
PUNCTURED_CELL = ("k7_r34_batch", 1 << 24, "3/4", 64)


def _punctured_row():
    """The punctured framing kernel at the k7_r34_batch call (2^24 stages
    at rate 3/4 in float32, a few thousand symbols poisoned, the frames
    padded to the tile): bit for bit against its plain version and the ATen
    chain it replaces on the card (the clip, the depuncture, the rate-1/2
    framing kernel with its clip off and the pad to the tile), then the
    three timed in turns (min of 4 rounds of 20 launches, CUDA events),
    beside the bytes bound."""
    import torch
    from repro_torch.channel.sim import channel
    from repro_torch.core.puncture import depuncture
    from repro_torch.core.sanitize import LLR_CLIP
    from repro_torch.kernels import framing, ops
    from repro_torch.launch.roofline import kernel_bound
    cell, n, rate, tile = PUNCTURED_CELL
    spec = main_config(rate, "kernel").spec
    gen = torch.Generator(device="cuda").manual_seed(SEED + n + 3)
    _, x = channel(gen, n, EBN0_DB, rate)
    idx = torch.randint(0, x.numel(), (4096,), generator=gen, device="cuda")
    poison = torch.tensor(FRAMING_PLANTED, device="cuda")
    x[idx] = poison[torch.arange(idx.numel(), device="cuda")
                    % poison.numel()]
    rows = ops.tile_rows(spec.num_frames(n), tile)

    def kernel():
        return framing.frame_punctured_cuda(x, rate, n, spec, LLR_CLIP, rows)

    def plain():
        return framing.frame_punctured_plain(x, rate, n, spec, LLR_CLIP, rows)

    def chain():
        llr = depuncture(framing.clip_llr_plain(x, LLR_CLIP), rate, n)
        return ops._pad_frames(framing.frame_llr_cuda(llr, spec), tile)[0]
    got = kernel()
    for name, fn in (("plain version", plain), ("ATen chain", chain)):
        if not torch.equal(got.view(torch.int32), fn().view(torch.int32)):
            raise AssertionError(f"frame_punctured {cell}: kernel != "
                                 f"{name}")
    del got
    ms = _interleaved({"kernel": kernel, "plain": plain, "chain": chain},
                      20, rounds=4)
    nbytes = (x.numel() + rows * spec.frame_len * 2) * 4
    bound_ms, bound_by = kernel_bound(nbytes, 0)
    return {"cell": cell, "n": n, "rate": rate, "rows": rows,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "chain_ms": ms["chain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes}


def time_framing(rx_half, launches):
    """The clip-and-frame kernel on the main path's rate-1/2 LLRs, clip on
    and off, then at the benchmark cells' calls: each bit for bit against
    its plain version and timed beside it and its bytes bound; then the
    punctured framing kernel at the k7_r34_batch call. Returns the kernels
    line's two entries (the rate-1/2 kernel's main-path clip-on row,
    ``cells`` the rest; the punctured kernel's cell row)."""
    import torch
    rows = [_framing_row(rx_half.reshape(N_BITS, 2).clone(), clip)
            for clip in (True, False)]
    for r in rows:
        log("time", _framing_line("frame_llr main path", r))
    cells = []
    for name, n, beta, clip in FRAMING_CELLS:
        gen = torch.Generator(device="cuda").manual_seed(SEED + n + beta)
        x = 3 * torch.randn((n, beta), generator=gen, device="cuda")
        cells.append(dict(_framing_row(x, clip), cell=name))
        log("time", _framing_line(f"frame_llr {name}", cells[-1]))
        del x
    main = rows[0]
    p = _punctured_row()
    log("time", f"frame_punctured {p['cell']} ({p['n']} stages, rate "
        f"{p['rate']}, {p['rows']} rows): {p['ms']:.4f} ms, ATen chain "
        f"{p['chain_ms']:.4f} ms ({p['chain_ms'] / p['ms']:.1f}x), plain "
        f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
        f"({p['bytes'] / 1e6:.1f} MB; {p['bound_ms'] / p['ms']:.1%} of the "
        f"bound, {p['bytes'] / p['ms'] / 1e6:.0f} GB/s)")
    source = "src/repro_torch/kernels/csrc/frame_llr.cu"
    return [{"name": "frame_llr", "route": "cuda", "source": source,
             "replaces": None, "launches": launches["frame_llr"],
             "max_abs_err": 0, "parity": "equal", "ms": main["ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None,
             "clip_off": rows[1], "cells": cells},
            {"name": "frame_punctured", "route": "cuda", "source": source,
             "replaces": None, "launches": launches["frame_punctured"],
             "max_abs_err": 0, "parity": "equal", "ms": p["ms"],
             "plain_ms": p["plain_ms"], "chain_ms": p["chain_ms"],
             "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
             "library_ms": None, "cells": [p]}]


def time_end_to_end(rx_half):
    """The paper's unified vs split comparison: whole make_decoder calls on
    the same card. E2E_ROUNDS rounds in turns (kernel, split, split,
    kernel, ...), each E2E_CALLS calls back to back: their time per call on
    the card's clock (CUDA events, synchronised after), and the host's time
    per call until the last one returns, before the synchronisation. The
    rate-1/2 path syncs nowhere, so that is what dispatching a call costs
    the host: where it reaches the call's time, the card waits on the
    host. Returns the median ms per call by backend."""
    import statistics
    import torch
    from repro_torch.core.pipeline import make_decoder
    rx = rx_half.reshape(-1)
    calls = {}
    for backend in ("kernel", "kernel_split"):
        decode = make_decoder(main_config("1/2", backend), "cuda")
        decode(rx, N_BITS)
        calls[backend] = (lambda d=decode: d(rx, N_BITS))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    card = {b: [] for b in calls}
    host = {b: [] for b in calls}
    order = list(calls)
    for r in range(E2E_ROUNDS):
        for b in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in range(E2E_CALLS):
                calls[b]()
            host[b].append((time.perf_counter() - t0) * 1e3 / E2E_CALLS)
            end.record()
            torch.cuda.synchronize()
            card[b].append(start.elapsed_time(end) / E2E_CALLS)
    ms = {}
    for b in calls:
        q, h = (statistics.quantiles(x[b], n=4) for x in (card, host))
        ms[b] = statistics.median(card[b])
        log("time", f"make_decoder rate 1/2 end to end, {b}: median "
            f"{ms[b]:.4f} ms per call (q1 {q[0]:.4f}, q3 {q[2]:.4f}, min "
            f"{min(card[b]):.4f}; {N_BITS / ms[b] / 1e3:.1f} Mb/s); host "
            f"dispatch median {statistics.median(host[b]):.4f} ms per call "
            f"(q1 {h[0]:.4f}, q3 {h[2]:.4f}); {E2E_ROUNDS} rounds of "
            f"{E2E_CALLS} calls")
    log("time", f"split / unified = "
        f"{ms['kernel_split'] / ms['kernel']:.3f} (medians)")
    return ms


def time_planner(frames):
    """plan_decode(measure=True) at the main shape into a temporary tune DB,
    then again from the DB without measuring."""
    from repro_torch.core.trellis import STD_K7
    from repro_torch.kernels.autotune import plan_decode
    from repro_torch.kernels.tunedb import TuneDB
    spec = main_config("1/2", "kernel").spec
    F = frames.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for unified in (True, False):
            db = TuneDB(str(Path(tmp) / f"tunedb-{unified}.json"))
            t0 = time.perf_counter()
            plan = plan_decode(STD_K7, spec, unified=unified, measure=True,
                               tunedb=db, measure_frames=F, device="cuda")
            sec = time.perf_counter() - t0
            again = TuneDB(db.path)
            plan2 = plan_decode(STD_K7, spec, unified=unified, measure=True,
                                tunedb=again, measure_frames=F, device="cuda")
            if again.stats()["measures"] != 0 or plan2 != plan:
                raise AssertionError("the tune DB did not serve the second "
                                     f"plan_decode: {again.stats()}")
            rows = {fp: round(r["ms"], 4) for fp, r in
                    json.loads(Path(db.path).read_text())["platforms"]
                    .popitem()[1].items()}
            out[plan.tile.kernel] = (plan, sec, rows)
    for kernel, (plan, sec, rows) in out.items():
        log("time", f"plan_decode(measure=True, {kernel}) at F={F}: "
            f"{sec:.2f} s (host clock); chose tile "
            f"{plan.frames_per_tile} {plan.tile.layout.value}, measured ms "
            f"by fingerprint {rows}; re-read from the DB with 0 measures")


def phase_time(frames, rx_half, launches, gen):
    """Returns the kernels' JSON entries and the whole calls' ms."""
    unified = time_unified(frames, launches)
    split = time_split(frames, launches)
    framing = time_framing(rx_half, launches)       # two entries
    large = time_large_codes(gen)
    unified["large_codes"] = large["viterbi_unified"]
    split["fwd"]["large_codes"] = large["viterbi_fwd"]
    wide = time_wide_codes(gen)
    for entry in (unified, split["fwd"], split["tb"]):
        entry["wide_codes"] = wide[entry["name"]]
    calls = time_end_to_end(rx_half)
    time_planner(frames)
    return [unified, split["fwd"], split["tb"], *framing], calls


def phase_profile(rx_half, call_ms):
    """Device time by kernel over one warm make_decoder call per backend,
    and the glue's share: device time outside the decode kernels (clip,
    depuncture, frame gather, pad, copies) against the whole call's time
    from phase 5 (CUDA events, no profiler) and against the device's busy
    time in the profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.pipeline import make_decoder
    rx = rx_half.reshape(-1)
    for backend in ("kernel", "kernel_split"):
        decode = make_decoder(main_config("1/2", backend), "cuda")
        decode(rx, N_BITS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode(rx, N_BITS)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            # device-side rows only (kernels, copies): an operator's row
            # repeats the time of the kernels it launched
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                rows.append((ev.self_device_time_total, ev.key, ev.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        decode = sum(us for us, k, _ in rows
                     if any(name in k for name in DECODE_KERNELS))
        glue = busy - decode
        log("profile", f"{backend}, one call: host {wall_us:.0f} us, device "
            f"busy {busy:.0f} us ({busy / wall_us:.0%}); by kernel: "
            + "; ".join(f"{k[:60]} x{c} {us:.0f} us" for us, k, c in rows[:8]))
        log("profile", f"{backend}: decode kernels {decode:.0f} us, glue "
            f"{glue:.0f} us = {glue / (call_ms[backend] * 1e3):.1%} of the "
            f"{call_ms[backend]:.3f} ms call (phase 5), {glue / busy:.1%} of "
            f"the device's busy time")


STREAM_BITS = 1 << 24
#: One-wave chunks the one-wave stream run spans at least, so that the
#: double-buffered dispatch runs through several of them.
STREAM_WAVES = 6
STREAM_SMALL_BITS = 1 << 18
SERVE_BITS = 1 << 16
SERVE_SESSIONS = (192, 64)              # rate 1/2, rate 3/4
SERVE_SLOTS = 64
SERVE_CHUNK = 64


def _reset_counts():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _slices(rng, total, rate, lo=1 << 10, hi=1 << 16):
    """Seeded random push sizes of lo..hi decoded bits covering ``total``
    input rows (stages at rate 1/2, raw symbols at rate 3/4: 4/3 a bit)."""
    per_bit = 1.0 if rate == "1/2" else 4.0 / 3.0
    out, pos = [], 0
    while pos < total:
        sz = max(1, int(rng.integers(lo, hi + 1) * per_bit))
        out.append((pos, min(total, pos + sz)))
        pos += sz
    return out


def _pctl(xs, p):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), p)) if xs else 0.0


def device_busy(fn):
    """Run ``fn`` under torch.profiler; returns (wall ms on the host clock,
    device busy ms by kind: B1, copies in and out, other kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = {"B1": 0.0, "copy_in": 0.0, "copy_out": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        kind = ("B1" if "viterbi_unified_kernel" in ev.key
                or "viterbi_unified_thread_kernel" in ev.key else
                "copy_in" if "HtoD" in ev.key else
                "copy_out" if "DtoH" in ev.key else "other")
        busy[kind] += ev.self_device_time_total / 1e3
    return wall, busy


def _busy_line(wall, busy):
    total = sum(busy.values())
    return (f"wall {wall:.1f} ms, device busy {total:.2f} ms "
            f"({total / wall:.1%}; idle {1 - total / wall:.1%}): " +
            ", ".join(f"{k} {v:.2f} ms" for k, v in busy.items()))


def one_wave_chunk(cfg):
    """The plan's resident frames per SM x the SM count, rounded up to a
    multiple of the tile (one device)."""
    import torch
    from repro_torch.kernels.autotune import plan_decode
    plan = plan_decode(cfg.trellis, cfg.spec, pack_survivors=True, radix=4,
                       device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ft = plan.frames_per_tile
    wave = -(-plan.tile.frames_per_sm * sms // ft) * ft
    return wave, plan


def _stream_run(cfg, rx_host, n, chunk, rng, mesh=None):
    """One stream_decode-path run; returns (bits, wall s, host_ms, counts,
    pushes, chunk frames). ``chunk=None`` is the planner's default."""
    import torch
    from repro_torch.core.stream import make_stream_decoder
    dec = make_stream_decoder(cfg, chunk_frames=chunk, device="cuda",
                              mesh=mesh)
    src = rx_host if cfg.rate != "1/2" else rx_host.reshape(-1, 2)
    cuts = _slices(rng, src.shape[0], cfg.rate)
    torch.cuda.synchronize()
    counters = _reset_counts()
    t0 = time.perf_counter()
    parts = [dec.push(src[a:b]) for a, b in cuts]
    parts.append(dec.flush())
    wall = time.perf_counter() - t0
    counts = _read_counts(counters)
    import numpy as np
    return (np.concatenate(parts)[:n], wall, dec.host_ms(), counts,
            len(cuts), dec.chunk_frames)


def _no_sync_check(cfg, rx_host, chunk, mesh=None):
    """Behind a spinning kernel, dispatch two chunks with depth 1: just
    after chunk i+1 is dispatched, chunk i's event must still be pending
    (nothing on the dispatch path synchronised)."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline import make_decoder
    from repro_torch.core.stream import make_stream_decoder
    dec = make_stream_decoder(cfg, chunk_frames=chunk, depth=1,
                              device="cuda", mesh=mesh)
    src = rx_host.reshape(-1, 2)
    need = 2 * chunk * cfg.spec.f + cfg.spec.v2
    t0 = time.perf_counter()
    dec.push(src[:chunk * cfg.spec.f])          # builds the programs
    dec.flush()
    warm = time.perf_counter() - t0
    # the two chunks' windows are cut on the host before the spin: at a
    # one-wave chunk of the thread mapping (38,016 frames) that takes
    # seconds and is not the dispatch path; the spin (at least ~0.25 s)
    # outlasts twice a warm chunk's push, dispatch and drain
    dec._ctx.append(src[:need])
    w0, w1 = dec._ctx.take_windows()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(5e8, 2 * warm * 2e9)))
    t0 = time.perf_counter()
    dec._dispatch(w0)
    dec._dispatch(w1)
    host = (time.perf_counter() - t0) * 1e3
    first = dec._inflight[0][0].event
    pending = not first.query()
    bits = np.concatenate(dec._drain(0))
    dec._ctx.reset()
    want = make_decoder(cfg, "cuda")(src[:need], need).cpu().numpy()
    if not np.array_equal(bits, want[:2 * chunk * cfg.spec.f]):
        raise AssertionError("no-sync check: bits != make_decoder")
    if not pending:
        raise AssertionError("chunk i's event had completed just after "
                             "chunk i+1 was dispatched behind a spinning "
                             "kernel: the dispatch path synchronised")
    return host


def phase_stream(gen):
    """Returns each kernel's launches over the stream runs."""
    import numpy as np
    import torch
    from repro_torch.channel.sim import channel
    from repro_torch.core.pipeline import make_decoder
    rng = np.random.default_rng(SEED)
    total = {k: 0 for k in _counters()}
    for rate in ("1/2", "3/4"):
        cfg = main_config(rate, "kernel")
        wave, plan = one_wave_chunk(cfg)
        waves = 1 << (STREAM_WAVES * wave * cfg.spec.f - 1).bit_length()
        for n, chunk, label in ((max(STREAM_BITS, waves), wave, "one wave"),
                                (STREAM_SMALL_BITS, plan.chunk_frames,
                                 "default")):
            _, rx = channel(gen, n, EBN0_DB, rate)
            want = make_decoder(cfg, "cuda")(rx, n).cpu().numpy()
            rx_host = rx.cpu().numpy()
            bits, wall, host, counts, pushes, _ = _stream_run(
                cfg, rx_host, n, chunk, rng)
            chunks = host["chunks"]
            if counts != {"viterbi_unified": chunks, "viterbi_fwd": 0,
                          "traceback_frames": 0, "frame_llr": 0,
                          "frame_punctured": 0}:
                raise AssertionError(f"stream rate {rate} {label}: launches "
                                     f"{counts} for {chunks} chunks")
            if not (bits.shape == (n,) and np.array_equal(bits, want)):
                raise AssertionError(f"stream rate {rate} {label}: bits != "
                                     f"make_decoder")
            for k, v in counts.items():
                total[k] += v
            per = {k: round(host[k] / chunks, 4)
                   for k in ("framing", "copy_in", "dispatch", "drain")}
            log("stream", f"rate {rate} {label} chunk {chunk} frames "
                f"({chunk * cfg.spec.f} bits): n={n} in {pushes} pushes, "
                f"{chunks} chunks, {n / wall / 1e6:.1f} Mb/s ({wall:.3f} s "
                f"host clock, push to flush); B1 launches "
                f"{counts['viterbi_unified']}; host ms per chunk {per} "
                f"(sum {sum(per.values()):.4f} of "
                f"{wall * 1e3 / chunks:.4f}); bits equal make_decoder")
        if rate == "1/2":
            _, rx = channel(gen, 1 << 22, EBN0_DB, rate)
            rx_host = rx.cpu().numpy()
            wall, busy = device_busy(lambda: _stream_run(
                cfg, rx_host, 1 << 22, wave, rng))
            log("stream", f"profile, rate 1/2 one wave, n=2^22: "
                + _busy_line(wall, busy))
            _, rx = channel(gen, 4 * wave * cfg.spec.f, EBN0_DB, rate)
            host = _no_sync_check(cfg, rx.cpu().numpy(), wave)
            log("stream", f"no-sync check: two one-wave chunks dispatched "
                f"in {host:.3f} ms behind a spinning kernel; chunk i's "
                f"event still pending after chunk i+1's dispatch; bits "
                f"equal")
    return total


def _session_streams(gen, rates, n):
    """One received stream per session, made on the card, kept on the
    host (numpy), and make_decoder's bits for it."""
    from repro_torch.channel.sim import channel
    from repro_torch.core.pipeline import make_decoder
    out = []
    decoders = {}
    for rate in rates:
        cfg = main_config(rate, "kernel")
        if rate not in decoders:
            decoders[rate] = make_decoder(cfg, "cuda")
        _, rx = channel(gen, n, EBN0_DB, rate)
        out.append((cfg, rx.cpu().numpy(),
                    decoders[rate](rx, n).cpu().numpy()))
    return out


def _serve_loop(srv, streams, rng, n, lo=1 << 10, hi=1 << 14,
                step_ms=None, stop_at=None):
    """Push every session's stream in seeded random slices, interleaved
    across sessions in a random order each round; step and poll until
    every slice went in. Returns (sids, bits so far, positions)."""
    from repro_torch.serve import Backpressure
    sids = [srv.open_session(cfg, chunk_frames=SERVE_CHUNK)
            for cfg, _, _ in streams]
    pos = [0] * len(streams)
    got = {sid: [] for sid in sids}
    srcs = [rx if cfg.rate != "1/2" else rx.reshape(-1, 2)
            for cfg, rx, _ in streams]
    while any(p < s.shape[0] for p, s in zip(pos, srcs)):
        for j in rng.permutation(len(streams)):
            src = srcs[j]
            if pos[j] >= src.shape[0] or (
                    stop_at is not None and pos[j] >= stop_at(src)):
                continue
            per_bit = 1.0 if streams[j][0].rate == "1/2" else 4.0 / 3.0
            sz = max(1, int(rng.integers(lo, hi + 1) * per_bit))
            if stop_at is not None:
                sz = min(sz, stop_at(src) - pos[j])
            try:
                srv.push(sids[j], src[pos[j]:pos[j] + sz])
                pos[j] += sz
            except Backpressure:
                pass
        t0 = time.perf_counter()
        srv.step()
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        for sid in sids:
            got[sid].append(srv.poll(sid))
        if stop_at is not None and all(
                p >= stop_at(s) for p, s in zip(pos, srcs)):
            break
    return sids, got, pos


def _check_sessions(srv, streams, sids, got, n, what):
    import numpy as np
    for sid, (cfg, _, want) in zip(sids, streams):
        got[sid].append(srv.close_session(sid))
        bits = np.concatenate(got[sid])[:n]
        if not np.array_equal(bits, want):
            raise AssertionError(f"{what}: session {sid} (rate {cfg.rate}) "
                                 f"!= make_decoder")


def phase_serve(gen):
    """Returns each kernel's launches over the serve runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.obs import Tracer
    from repro_torch.serve import DecodeServer, PlanCache
    from repro_torch.testing import FaultInjector, FaultSpec
    rng = np.random.default_rng(SEED + 1)
    n = SERVE_BITS
    rates = ["1/2"] * SERVE_SESSIONS[0] + ["3/4"] * SERVE_SESSIONS[1]
    rates = [rates[i] for i in rng.permutation(len(rates))]
    streams = _session_streams(gen, rates, n)
    total = {k: 0 for k in _counters()}

    # -- the clean run --------------------------------------------------
    cache, tracer = PlanCache(), Tracer()
    srv = DecodeServer(slots=SERVE_SLOTS, max_sessions=len(streams),
                       cache=cache, trace=tracer, device="cuda")
    steps = []
    torch.cuda.synchronize()
    counters = _reset_counts()
    t0 = time.perf_counter()
    sids, got, _ = _serve_loop(srv, streams, rng, n, step_ms=steps)
    tc = time.perf_counter()
    for sid in sids:
        got[sid].append(srv.close_session(sid))
    wall = time.perf_counter() - t0
    counts = _read_counts(counters)
    for sid, (cfg, _, want) in zip(sids, streams):
        if not np.array_equal(np.concatenate(got[sid])[:n], want):
            raise AssertionError(f"serve: session {sid} (rate {cfg.rate}) "
                                 f"!= make_decoder")
    snap = srv.metrics_snapshot()
    tot = snap["totals"]
    faults = {c: tot[c] for c in ("launch_errors", "retries", "timeouts",
                                  "degraded", "breaker_trips", "evacuated")}
    if any(faults.values()):
        raise AssertionError(f"serve: fault counters {faults} in a clean run")
    if counts != {"viterbi_unified": tot["launches"], "viterbi_fwd": 0,
                  "traceback_frames": 0, "frame_llr": 0,
                  "frame_punctured": 0}:
        raise AssertionError(f"serve: launches {counts}, server "
                             f"{tot['launches']}")
    programs = {(r.attrs["bucket"], r.attrs["frames"])
                for r in tracer.spans() if r.name == "launch"}
    stats = cache.stats()
    if stats["traces"] != len(programs):
        raise AssertionError(f"serve: plan cache traces {stats['traces']} != "
                             f"{len(programs)} distinct (bucket, batch) "
                             f"programs")
    for k, v in counts.items():
        total[k] += v
    full = sum(1 for b, f in programs if f == SERVE_SLOTS * SERVE_CHUNK)
    log("serve", f"{len(streams)} sessions ({SERVE_SESSIONS[0]} rate 1/2, "
        f"{SERVE_SESSIONS[1]} rate 3/4), {n} bits each, slots "
        f"{SERVE_SLOTS} x chunk {SERVE_CHUNK}: {tot['windows']} windows in "
        f"{tot['launches']} launches ({len(programs)} programs, {full} at "
        f"the full {SERVE_SLOTS * SERVE_CHUNK} frames) in {wall:.3f} s "
        f"({tot['windows'] / wall:.1f} windows/s, "
        f"{tot['bits'] / wall / 1e6:.1f} Mb/s; pushes and steps "
        f"{tc - t0:.3f} s, closes {wall - (tc - t0):.3f} s); step p50 "
        f"{_pctl(steps, 50):.3f} ms p99 {_pctl(steps, 99):.3f} ms over "
        f"{len(steps)} steps; window latency p50 {tot['p50_ms']:.3f} ms "
        f"p99 {tot['p99_ms']:.3f} ms; occupancy {tot['occupancy']:.4f}; "
        f"B1 launches {counts['viterbi_unified']} = server launches; "
        f"fault counters 0; plan cache {stats}")
    log("serve", "stage ms (p50/p99/count): " + "; ".join(
        f"{k} {v['p50']}/{v['p99']}/{v['count']}"
        for k, v in snap["stages"].items()))

    def profiled():
        srv = DecodeServer(slots=SERVE_SLOTS, cache=PlanCache(),
                           device="cuda")
        sids, got, _ = _serve_loop(srv, streams[:64], rng, n)
        for sid in sids:
            srv.close_session(sid)
    wall, busy = device_busy(profiled)
    log("serve", "profile, 64 of the sessions, the same loop: "
        + _busy_line(wall, busy))

    # -- drain(checkpoint) -> restore, mid-stream ------------------------
    sub = streams[:16]
    srv = DecodeServer(slots=SERVE_SLOTS, cache=PlanCache(), device="cuda")
    half = (lambda src: src.shape[0] // 2)
    sids, got, pos = _serve_loop(srv, sub, rng, n, stop_at=half)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve.ckpt.json")
        srv.drain(checkpoint=path)     # undelivered bits go with it
        srv2 = DecodeServer.restore(path, cache=PlanCache(), device="cuda")
    for sid, p, (cfg, rx, _) in zip(sids, pos, sub):
        src = rx if cfg.rate != "1/2" else rx.reshape(-1, 2)
        srv2.push(sid, src[p:p + src.shape[0] // 4])
        srv2.step()
        srv2.push(sid, src[p + src.shape[0] // 4:])
    srv2.drain()
    _check_sessions(srv2, sub, sids, got, n, "checkpoint/restore")
    log("serve", f"drain(checkpoint) -> restore at mid-stream: {len(sub)} "
        f"sessions resumed on the card, bits equal make_decoder")

    # -- seeded faults: launch errors and one poisoned push ---------------
    sub = list(streams[16:48])
    inj = FaultInjector(FaultSpec("launch_error", p=0.3),
                        FaultSpec("corrupt_llr", every=1, sessions=(0,),
                                  mode="nan", frac=0.01), seed=SEED)
    srv = DecodeServer(slots=8, cache=PlanCache(), device="cuda",
                       faults=inj, max_retries=2, backoff_s=0.0,
                       breaker_threshold=1000)
    j = next(i for i, (cfg, _, _) in enumerate(sub) if cfg.rate == "1/2")
    poisoned_cfg, poisoned_rx, _ = sub.pop(j)
    bad = poisoned_rx.reshape(-1, 2)[:1024]
    bad_sid = srv.open_session(poisoned_cfg, chunk_frames=SERVE_CHUNK)
    if bad_sid != 0:
        raise AssertionError(f"the poisoned session is {bad_sid}, not 0")
    srv.push(bad_sid, bad)                      # the one poisoned push
    sids, got, _ = _serve_loop(srv, sub, rng, n)
    srv.close_session(bad_sid)
    _check_sessions(srv, sub, sids, got, n, "fault run")
    tot = srv.metrics.totals()
    inj_stats = inj.stats()["injected"]
    want = {"launch_errors": inj_stats.get("launch_error", 0),
            "retries": inj_stats.get("launch_error", 0) - tot["degraded"],
            "poisoned_pushes": inj_stats.get("corrupt_llr", 0),
            "sanitized_values": int(0.01 * bad.size)}
    seen = {k: tot[k] for k in want}
    if seen != want or want["launch_errors"] == 0 or want[
            "poisoned_pushes"] != 1:
        raise AssertionError(f"fault run: counters {seen}, schedule {want}")
    log("serve", f"fault run: {len(sub)} healthy sessions + 1 poisoned "
        f"push; injected {inj_stats}; counters {seen}, degraded "
        f"{tot['degraded']}; healthy sessions' bits equal make_decoder")

    # -- one kernel_split bucket of 16 sessions --------------------------
    sub = [(dataclasses.replace(cfg, backend="kernel_split"), rx, want)
           for cfg, rx, want in streams if cfg.rate == "1/2"][:16]
    srv = DecodeServer(slots=16, cache=PlanCache(), device="cuda")
    counters = _reset_counts()
    sids, got, _ = _serve_loop(srv, sub, rng, n)
    _check_sessions(srv, sub, sids, got, n, "kernel_split bucket")
    counts = _read_counts(counters)
    launches = srv.metrics.totals()["launches"]
    if counts != {"viterbi_unified": 0, "viterbi_fwd": launches,
                  "traceback_frames": launches, "frame_llr": 0,
                  "frame_punctured": 0} or len(
                      srv.buckets()) != 1:
        raise AssertionError(f"kernel_split bucket: launches {counts}, "
                             f"server {launches}")
    for k, v in counts.items():
        total[k] += v
    log("serve", f"kernel_split bucket: {len(sub)} sessions in {launches} "
        f"launches of B3 and the traceback kernel, bits equal make_decoder")
    return total


MESH_STREAM_BITS = 1 << 22
MESH_SMALL_BITS = 1 << 16
MESH_SESSIONS = (12, 4)                 # rate 1/2, rate 3/4
DRYRUN_BITS = 10 ** 8


def _add(total, counts):
    for k, v in counts.items():
        total[k] += v


def _b1_only(counts, n, what):
    want = {"viterbi_unified": n, "viterbi_fwd": 0, "traceback_frames": 0,
            "frame_llr": 0, "frame_punctured": 0}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def mesh_frames(mesh, frames, label, total):
    """make_sharded_frame_decoder over ``mesh`` at the main shape (and one
    frame fewer on a mesh of two or more, for the padding): bits equal the
    unsharded frame decoder, one B1 launch per shard; ms beside the
    unsharded call's, timed in turns."""
    import torch
    from repro_torch.core.pipeline import make_frame_decoder
    from repro_torch.distributed import make_sharded_frame_decoder
    cfg = main_config("1/2", "kernel")
    sharded = make_sharded_frame_decoder(cfg, mesh)
    plain = make_frame_decoder(cfg, "cuda")
    for F in (frames.shape[0],) + ((frames.shape[0] - 1,)
                                   if mesh.size > 1 else ()):
        fr = frames[:F]
        want = plain(fr)
        torch.cuda.synchronize()
        counters = _reset_counts()
        got = sharded(fr)
        torch.cuda.synchronize()
        counts = _read_counts(counters)
        _b1_only(counts, mesh.size, f"sharded frames {label} F={F}")
        _add(total, counts)
        if not (got.shape == want.shape and torch.equal(got, want)):
            raise AssertionError(f"sharded frames {label} F={F}: bits != "
                                 f"the unsharded frame decoder")
        ms = _interleaved({"sharded": lambda: sharded(fr),
                           "unsharded": lambda: plain(fr)}, 10, rounds=4)
        log("mesh", f"make_sharded_frame_decoder {label} F={F}: "
            f"{ms['sharded']:.4f} ms vs unsharded {ms['unsharded']:.4f} ms "
            f"({ms['sharded'] / ms['unsharded']:.3f}x; min of 4 rounds of "
            f"10 calls, CUDA events); B1 launches {counts['viterbi_unified']}"
            f" = shards; bits equal")


def mesh_stream(gen, mesh, label, total, rates=("1/2", "3/4")):
    """stream_decode's path over ``mesh``: n = 2^22 at one wave per shard,
    then 2^16 at the mesh's default chunk; bits equal make_decoder, B1
    launches equal chunks x shards; then the no-sync check."""
    import numpy as np
    from repro_torch.channel.sim import channel
    from repro_torch.core.pipeline import make_decoder
    rng = np.random.default_rng(SEED + 2)
    for rate in rates:
        cfg = main_config(rate, "kernel")
        wave, _ = one_wave_chunk(cfg)
        for n, chunk, what in ((MESH_STREAM_BITS, wave * mesh.size,
                                "one wave per shard"),
                               (MESH_SMALL_BITS, None, "default")):
            _, rx = channel(gen, n, EBN0_DB, rate)
            want = make_decoder(cfg, "cuda")(rx, n).cpu().numpy()
            bits, wall, host, counts, pushes, chunk = _stream_run(
                cfg, rx.cpu().numpy(), n, chunk, rng, mesh=mesh)
            _b1_only(counts, host["chunks"] * mesh.size,
                     f"stream {label} rate {rate} {what}")
            _add(total, counts)
            if not (bits.shape == (n,) and np.array_equal(bits, want)):
                raise AssertionError(f"stream {label} rate {rate} {what}: "
                                     f"bits != make_decoder")
            log("mesh", f"stream {label} rate {rate} {what}, chunk {chunk} "
                f"frames: n={n} in {pushes} pushes, {host['chunks']} chunks, "
                f"{n / wall / 1e6:.1f} Mb/s ({wall:.3f} s host clock); B1 "
                f"launches {counts['viterbi_unified']} = chunks x "
                f"{mesh.size}; bits equal make_decoder")
        if rate == "1/2":
            chunk = wave * mesh.size
            _, rx = channel(gen, 4 * chunk * cfg.spec.f, EBN0_DB, rate)
            counters = _reset_counts()
            host = _no_sync_check(cfg, rx.cpu().numpy(), chunk, mesh=mesh)
            _add(total, _read_counts(counters))
            log("mesh", f"no-sync check {label}: two chunks of {chunk} "
                f"frames dispatched in {host:.3f} ms behind a spinning "
                f"kernel; chunk i's event still pending after chunk i+1's "
                f"dispatch; bits equal")


def mesh_serve(gen, mesh, label, total):
    """One DecodeServer over ``mesh``: 16 sessions, bits equal make_decoder,
    B1 launches equal the server's launches x shards; then
    drain(checkpoint) and restore under the same mesh, bits equal."""
    import numpy as np
    from repro_torch.serve import DecodeServer, PlanCache
    rng = np.random.default_rng(SEED + 3)
    n = SERVE_BITS
    rates = ["1/2"] * MESH_SESSIONS[0] + ["3/4"] * MESH_SESSIONS[1]
    streams = _session_streams(gen, [rates[i] for i in
                                     rng.permutation(len(rates))], n)
    srv = DecodeServer(slots=8, mesh=mesh, cache=PlanCache(), device="cuda")
    counters = _reset_counts()
    t0 = time.perf_counter()
    sids, got, _ = _serve_loop(srv, streams, rng, n)
    _check_sessions(srv, streams, sids, got, n, f"serve {label}")
    wall = time.perf_counter() - t0
    counts = _read_counts(counters)
    tot = srv.metrics.totals()
    _b1_only(counts, tot["launches"] * mesh.size, f"serve {label}")
    _add(total, counts)
    log("mesh", f"DecodeServer {label}: {len(streams)} sessions "
        f"({MESH_SESSIONS[0]} rate 1/2, {MESH_SESSIONS[1]} rate 3/4), "
        f"{tot['windows']} windows in {tot['launches']} launches, "
        f"{tot['bits'] / wall / 1e6:.1f} Mb/s ({wall:.3f} s); B1 launches "
        f"{counts['viterbi_unified']} = launches x {mesh.size}; bits equal "
        f"make_decoder")
    srv = DecodeServer(slots=8, mesh=mesh, cache=PlanCache(), device="cuda")
    counters = _reset_counts()
    sids, got, pos = _serve_loop(srv, streams, rng, n,
                                 stop_at=lambda src: src.shape[0] // 2)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve.ckpt.json")
        srv.drain(checkpoint=path)
        srv2 = DecodeServer.restore(path, mesh=mesh, cache=PlanCache(),
                                    device="cuda")
    if srv2.mesh != mesh:
        raise AssertionError(f"restored server's mesh {srv2.mesh}")
    for sid, p, (cfg, rx, _) in zip(sids, pos, streams):
        src = rx if cfg.rate != "1/2" else rx.reshape(-1, 2)
        srv2.push(sid, src[p:p + src.shape[0] // 4])
        srv2.step()
        srv2.push(sid, src[p + src.shape[0] // 4:])
    srv2.drain()
    _check_sessions(srv2, streams, sids, got, n,
                    f"serve {label} checkpoint/restore")
    _add(total, _read_counts(counters))
    log("mesh", f"drain(checkpoint) -> restore under {label} at "
        f"mid-stream: {len(streams)} sessions resumed, bits equal "
        f"make_decoder")


def phase_mesh(gen, frames):
    """Returns each kernel's launches over phase 9."""
    import torch
    from repro_torch.distributed import FrameMesh, frame_mesh
    from repro_torch.launch import viterbi_dryrun
    total = {k: 0 for k in _counters()}
    one, two = FrameMesh(("cuda:0",)), FrameMesh(("cuda:0", "cuda:0"))
    mesh_frames(one, frames, "[cuda:0]", total)
    mesh_frames(two, frames, "[cuda:0, cuda:0]", total)
    mesh_stream(gen, two, "[cuda:0, cuda:0]", total)
    mesh_serve(gen, two, "[cuda:0, cuda:0]", total)
    cards = torch.cuda.device_count()
    if cards >= 2:
        every = frame_mesh()
        label = f"frame_mesh() ({cards} cards)"
        mesh_frames(every, frames, label, total)
        mesh_stream(gen, every, label, total, rates=("1/2",))
        mesh_serve(gen, every, label, total)
    else:
        log("mesh", "one card: the checks across every card need two or "
            "more and did not run; the two-shard mesh on cuda:0 ran above")
    counters = _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):   # its JSON row is not our line
        row = viterbi_dryrun.main(["--nbits", str(DRYRUN_BITS), "--gpus",
                                   str(cards), "--run"])
    _add(total, _read_counts(counters))
    for line in out.getvalue().splitlines()[:-1]:
        log("mesh", "dry run: " + line)
    log("mesh", f"dry run at {DRYRUN_BITS} bits on {row['measured_chips']} "
        f"card(s): measured {row['measured_gbps']:.3f} Gb/s "
        f"({row['measured_s'] * 1e3:.3f} ms per decode) against the "
        f"decode_roofline bound {row['measured_bound_gbps']:.1f} Gb/s "
        f"({row['measured_bottleneck']}); home card HBM "
        f"{row['peak_memory_per_chip'] / 1e9:.2f} GB projected")
    return total


#: Phase 10 (lm): the serve loop at full width, as launch/serve.py's demo
#: drives it (6 requests of 4-11 prompt tokens from default_rng(0)).
LM_REQUESTS, LM_SLOTS, LM_GEN, LM_MAX_SEQ = 6, 4, 12, 96
LM_STEPS = 4
#: Card against the port on the CPU, float32 at matmul precision
#: "highest": the bound that holds the port to JAX on the CPU (the two
#: devices sum in other orders; a wrong operation moves logits >= 1e-2).
LM_F32_TOL = 1e-4
#: Incremental decode against the parallel forward on the card: float32
#: as above; bfloat16 rounds intermediate results at other places on the
#: two paths, so 5e-2, the bf16 parity tests' bound.
LM_INC_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: The same at full width in bfloat16, relative to the largest |logit|:
#: 2^-5, four times bf16's 2^-7 rounding step (8 significant bits), for
#: errors that grow through 4 layers of d_model 5120 before the final norm.
LM_FULL_REL_TOL = 2.0 ** -5
LM_DECODE_CHECK = ("qwen3_32b", "mamba2_2p7b", "jamba15_large",
                   "starcoder2_7b", "qwen3_moe_235b")



def lm_full_width_configs():
    """Qwen3-32B cut to 4 layers and Qwen3-235B-A22B cut to 2, every
    width as published (configs/qwen3_32b.py, configs/qwen3_moe_235b.py),
    in bfloat16."""
    from repro_torch.configs import get_config
    return [dataclasses.replace(get_config("qwen3_32b"), num_layers=4),
            dataclasses.replace(get_config("qwen3_moe_235b"), num_layers=2)]


def _lm_batch(cfg, B, S, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.vision_patches:
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in b.items()}


def _lm_prefill_decode(bundle, params, batch):
    """prefill's last logits, then LM_STEPS decode steps' logits from an
    empty cache, as one float32 tensor on the host."""
    import torch
    lg = [bundle.prefill(params, batch)]
    cache = bundle.init_cache(params, batch["tokens"].shape[0], 16)
    for t in range(LM_STEPS):
        out, cache = bundle.decode(params, batch["tokens"][:, t:t + 1],
                                   cache)
        lg.append(out)
    return torch.cat(lg, dim=1).float().cpu()


def _lm_inc_vs_parallel(cfg, params, B, S, device):
    """(max |incremental - parallel| over S positions, max |logit|) for
    ``cfg`` on ``params``; MoE capacity is lifted so that no drop depends
    on the batch shape (tests/test_decode_consistency.py)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_per_choice=float(cfg.moe.num_experts)))
    m = build_model(cfg, remat="none", device=device)
    toks = _lm_batch(cfg, B, S, device)["tokens"]
    with torch.no_grad():
        x, _ = T.forward(params, cfg, toks, remat="none")
        full = L.logits(params["embed"], x).float()
    cache = m.init_cache(params, B, S)
    inc = []
    for t in range(S):
        lg, cache = m.decode(params, toks[:, t:t + 1], cache)
        inc.append(lg[:, 0].float())
    inc = torch.stack(inc, dim=1)
    if not (bool(torch.isfinite(inc).all())
            and bool(torch.isfinite(full).all())):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return float((inc - full).abs().max()), float(full.abs().max())


def _lm_step_profile(bundle, params, steps: int = 3):
    """torch.profiler over ``steps`` warm batched decode steps at
    LM_SLOTS: (host ms per step under the profiler, device busy ms per
    step, the share of device time in matrix-product kernels, the top
    kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cache = bundle.init_cache(params, LM_SLOTS, LM_MAX_SEQ)
    tok = torch.ones((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    _, cache = bundle.decode(params, tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache = bundle.decode(params, tok, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy, mm_share, top = _device_rows(prof, steps)
    return wall, busy, mm_share, top[:5]


def _device_rows(prof, steps: int = 1):
    """(device busy ms per step, the share of it in matrix-product
    kernels, kernels by device time) from a torch.profiler run."""
    from torch.autograd import DeviceType
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / steps
    if not busy:
        raise AssertionError("torch.profiler saw no device time")
    mm = sum(us for us, k, _ in rows if any(    # cuBLAS(Lt)'s kernels
        w in k.lower() for w in ("nvjet", "gemm", "gemv", "xmma",
                                 "cutlass", "splitk"))) / 1e3 / steps
    return busy, mm / busy, rows


def lm_serve_full_width(cfg, smi: str) -> dict:
    """Random weights from SEED on the card, served by serve_requests;
    checks the tokens and incremental == parallel, prints the numbers."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build_model
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg, device="cuda")
    params = bundle.init(torch.Generator("cuda").manual_seed(SEED))
    nparams = sum(p.numel() for p in params.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
               for _ in range(LM_REQUESTS)]
    done, stats = serve_requests(bundle, params, prompts, LM_SLOTS, LM_GEN,
                                 LM_MAX_SEQ)
    toks = [t for v in done.values() for t in v]
    if sorted(done) != list(range(LM_REQUESTS)) or any(
            len(v) != LM_GEN for v in done.values()):
        raise AssertionError(f"{cfg.name}: requests served {sorted(done)}")
    if not all(0 <= t < cfg.padded_vocab for t in toks):
        raise AssertionError(f"{cfg.name}: token out of range")
    err, scale = _lm_inc_vs_parallel(cfg, params, 2, LM_STEPS, "cuda")
    if not err <= LM_FULL_REL_TOL * scale:
        raise AssertionError(
            f"{cfg.name}: incremental vs parallel {err} > "
            f"{LM_FULL_REL_TOL} x {scale}")
    from repro_torch.launch.mesh import HW
    prof_wall, prof_busy, mm_share, top = _lm_step_profile(bundle, params)
    step = statistics.median(stats["step_ms"])
    row = {"name": cfg.name, "layers": cfg.num_layers, "params": nparams,
           "weight_bytes": wbytes,
           "tokens_per_s": len(toks) / stats["seconds"],
           "decode_steps": stats["steps"], "step_ms_p50": step,
           "step_bound_ms": wbytes / HW.HBM_BW * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "inc_vs_parallel": err, "max_logit": scale,
           "profiled_step_ms": prof_wall, "device_busy_ms": prof_busy,
           "matmul_share": mm_share, "card": smi}
    log("lm", f"{cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {nparams / 1e9:.3f} B params, {wbytes / 1e9:.2f} "
        f"GB bf16): {LM_REQUESTS} requests x {LM_GEN} tokens over "
        f"{LM_SLOTS} slots, {row['tokens_per_s']:.1f} tokens/s, "
        f"{stats['steps']} batched steps, decode step p50 {step:.3f} ms "
        f"against the weight-bytes bound {row['step_bound_ms']:.3f} ms "
        f"({row['step_bound_ms'] / step:.1%}), peak memory "
        f"{row['peak_bytes'] / 1e9:.2f} GB; incremental vs parallel "
        f"{err:.4g} (max |logit| {scale:.4g}); card {smi}")
    log("lm", f"{cfg.name} profiled decode step: host {prof_wall:.3f} ms "
        f"(profiler on), "
        f"device busy {prof_busy:.3f} ms ({prof_busy / prof_wall:.1%}), "
        f"matrix products {mm_share:.1%} of device time; top: "
        + "; ".join(f"{k[:50]} x{c} {us / 1e3:.3f} ms" for us, k, c in top))
    return row


def phase_lm():
    """The LM scaffold's serve path (repro_torch.models, launch/serve)."""
    import gc
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build_model
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        if cfg.family == "encdec":
            continue                         # the serve path's archs
        cpu = build_model(cfg, device="cpu")
        card = build_model(cfg, device="cuda")
        params = cpu.init(torch.Generator().manual_seed(SEED))
        want = _lm_prefill_decode(cpu, params, _lm_batch(cfg, 2, 12, "cpu"))
        got = _lm_prefill_decode(card, copy.deepcopy(params).to("cuda"),
                                 _lm_batch(cfg, 2, 12, "cuda"))
        err = float((got - want).abs().max())
        log("lm", f"{arch} reduced f32: prefill + {LM_STEPS} decode steps, "
            f"card vs CPU max |d logit| {err:.3g} (bound {LM_F32_TOL})")
        if not err <= LM_F32_TOL:
            raise AssertionError(f"{arch}: card vs CPU {err}")
    for arch in LM_DECODE_CHECK:
        for dtype, tol in LM_INC_TOL.items():
            cfg = dataclasses.replace(get_config(arch, reduced=True),
                                      dtype=dtype)
            params = build_model(cfg, device="cuda").init(
                torch.Generator("cuda").manual_seed(SEED))
            err, _ = _lm_inc_vs_parallel(cfg, params, 2, 12, "cuda")
            log("lm", f"{arch} reduced {dtype}: incremental vs parallel "
                f"on the card {err:.3g} (bound {tol})")
            if not err < tol:
                raise AssertionError(f"{arch} {dtype}: {err}")
    smi = card_name_power()
    rows = []
    for cfg in lm_full_width_configs():
        rows.append(lm_serve_full_width(cfg, smi))
        gc.collect()                         # free one model before the next
        torch.cuda.empty_cache()
    return rows


#: Phase 11 (train): card against CPU on the reduced configs in float32,
#: the bounds that hold the port to JAX on the CPU (tests/_torch_train_
#: parity.py): the loss within 1e-5 relative, each gradient leaf within
#: 1e-4 of its own largest magnitude.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: Params after TRAIN_ADAM_STEPS AdamW steps at lr TRAIN_ADAM_LR: a wrong
#: update moves a param by about lr; Adam's normalisation amplifies the
#: devices' few-ulp gradient differences only where a gradient is near
#: eps, so lr / 10.
TRAIN_ADAM_LR, TRAIN_ADAM_STEPS = 1e-3, 2
TRAIN_PARAM_TOL = 1e-4
#: The autograd Functions against autograd through the plain formulations
#: on the card, relative to the largest magnitude: float32 1e-4; bfloat16
#: 2^-5, as phase 10 (the two round at other places; on the CPU at a
#: smaller shape they differed by <= 1.2e-2).
TRAIN_FN_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
#: The loop on the card: losses of replayed steps against their first
#: run, and against an uninterrupted run (float32; the embedding's
#: gradient is an atomic scatter-add, not bit-deterministic).
TRAIN_LOOP_TOL = 1e-4
#: The full-width cell: Qwen3-32B cut to 4 layers, global batch 2 x seq
#: 2048 (> attn_chunk 1024: the blockwise forward and flash backward),
#: adamw(warmup_cosine(1e-3, 2, 6)), 5 steps, then accumulation over 2
#: microbatches against one big-batch step from the same state (JAX's
#: tests/test_train_infra.py bound: losses within 5e-2, params 3e-2).
TRAIN_B, TRAIN_S, TRAIN_FULL_STEPS = 2, 2048, 5
TRAIN_ACCUM_TOL, TRAIN_ACCUM_PARAM_TOL = 5e-2, 3e-2
#: Bytes a param the optimizer moves: bf16 param read and write, bf16 grad
#: read, fp32 m and v read and write.
TRAIN_OPT_BYTES = 2 + 2 + 2 + 4 * 4


def _train_batch(cfg, B, S, device):
    import torch
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train.step import to_device
    batch = make_batch(cfg, DataConfig(B, S, seed=SEED), 0)
    return to_device(batch, torch.device(device))


def _loss_and_grads(bundle, params, batch):
    import torch
    loss = bundle.loss(params, batch)
    return float(loss.detach()), torch.autograd.grad(
        loss, list(params.parameters()))


def train_card_vs_cpu():
    """(a): every reduced architecture in float32, the same weights and
    batch on the card and on the CPU: loss, every gradient leaf, and the
    params after TRAIN_ADAM_STEPS AdamW steps."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.train import make_train_step
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        cpu = build_model(cfg, device="cpu")
        card = build_model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(SEED))
        p_card = copy.deepcopy(p_cpu).to("cuda")
        loss_c, g_c = _loss_and_grads(cpu, p_cpu,
                                      _train_batch(cfg, 2, 16, "cpu"))
        loss_g, g_g = _loss_and_grads(card, p_card,
                                      _train_batch(cfg, 2, 16, "cuda"))
        dloss = abs(loss_g - loss_c) / abs(loss_c)
        dgrad = max(float((b.cpu() - a).abs().max())
                    / max(float(a.abs().max()), 1e-30)
                    for a, b in zip(g_c, g_g))
        opt = adamw(constant(TRAIN_ADAM_LR))
        for bundle, p in ((cpu, p_cpu), (card, p_card)):
            step, o = make_train_step(bundle, opt), opt.init(p)
            for i in range(TRAIN_ADAM_STEPS):
                p, o, _ = step(p, o, make_batch(
                    cfg, DataConfig(2, 16, seed=SEED), i))
        dparam = max(float((b.detach().cpu() - a.detach()).abs().max())
                     for a, b in zip(p_cpu.parameters(), p_card.parameters()))
        log("train", f"{arch} reduced f32, card vs CPU: loss {dloss:.3g} "
            f"relative (bound {TRAIN_LOSS_RTOL}), grads {dgrad:.3g} of each "
            f"leaf's max (bound {TRAIN_GRAD_TOL}), params after "
            f"{TRAIN_ADAM_STEPS} AdamW steps {dparam:.3g} (bound "
            f"{TRAIN_PARAM_TOL})")
        if not (dloss <= TRAIN_LOSS_RTOL and dgrad <= TRAIN_GRAD_TOL
                and dparam <= TRAIN_PARAM_TOL):
            raise AssertionError(f"{arch}: card vs CPU {dloss} {dgrad} "
                                 f"{dparam}")


def _vjp_rel(fn, ref, inputs, cot):
    """max over outputs and input cotangents of |fn - ref| / max |ref|."""
    import torch
    out = []
    for f in (fn, ref):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        y = f(*xs)
        out.append([y.detach(), *torch.autograd.grad(y, xs, cot)])
    return max(float((a.float() - b.float()).abs().max())
               / float(b.float().abs().max()) for a, b in zip(*out))


def train_functions():
    """(b): the two autograd Functions on the card at Qwen3-32B's
    attention shape (H=64, KV=8, hd=128, chunk 1024, S=2048, B=1) and
    d_model (rms_norm at 5120), against autograd through the plain
    formulations on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen3_32b")
    H, KV, hd, c = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.attn_chunk
    gen = torch.Generator("cuda").manual_seed(SEED)
    for dtype, tol in TRAIN_FN_TOL.items():
        dt = getattr(torch, dtype)
        rnd = lambda *shape: torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)
        q, k, v = rnd(1, TRAIN_S, H, hd), rnd(1, TRAIN_S, KV, hd), rnd(
            1, TRAIN_S, KV, hd)
        attn = _vjp_rel(lambda q, k, v: L._sdpa_blockwise(q, k, v, c),
                        lambda q, k, v: L._sdpa_full(q, k, v, causal=True),
                        (q, k, v), rnd(1, TRAIN_S, H, hd))
        x, dy = rnd(1, TRAIN_S, cfg.d_model), rnd(1, TRAIN_S, cfg.d_model)
        w = 1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen,
                                    device="cuda")
        rms = _vjp_rel(lambda x, w: L.rms_norm(x, w, cfg.norm_eps),
                       lambda x, w: L.rms_norm_fp32(x, w, cfg.norm_eps),
                       (x, w), dy)
        log("train", f"{dtype}: flash backward vs autograd through "
            f"_sdpa_full at H={H} KV={KV} hd={hd} S={TRAIN_S} chunk {c}: "
            f"{attn:.3g} of the largest magnitude; rms_norm vs the fp32 "
            f"formulation at d={cfg.d_model}: {rms:.3g} (bound {tol})")
        if not (attn <= tol and rms <= tol):
            raise AssertionError(f"{dtype}: Functions vs plain {attn} {rms}")
        del q, k, v, x, dy
        torch.cuda.empty_cache()


def train_loop_card():
    """(c): train_loop on the card (reduced qwen3, float32) with a failure
    injected at step 7 and a checkpoint every 4 steps: one restore, the
    replayed steps' losses equal their first run and an uninterrupted
    run's, and a fresh loop resumes after the latest checkpoint."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import LoopConfig, make_train_step, train_loop
    from repro_torch.train import checkpoint as ckpt
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              dtype="float32")
    bundle = build_model(cfg, device="cuda")
    opt = adamw(warmup_cosine(3e-3, 10, 100))
    step = make_train_step(bundle, opt)

    def run(ckpt_dir, total, fail_at=None):
        params = bundle.init(torch.Generator("cuda").manual_seed(SEED))
        losses, fails = [], {fail_at}

        def step_fn(p, o, b):
            out = step(p, o, b)
            losses.append(float(out[2]["loss"]))
            return out

        def inj(s):
            if s in fails:
                fails.discard(s)
                raise RuntimeError("simulated node failure")

        stats = train_loop(step_fn, {"params": params,
                                     "opt": opt.init(params)},
                           SyntheticLM(cfg, DataConfig(4, 32,
                                                       mode="learnable")),
                           LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                      ckpt_every=4), fail_injector=inj)
        return stats, losses

    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        stats, losses = run(a, 10, fail_at=7)
        clean, want = run(b, 10)
        resumed, _ = run(a, 14)
        latest = ckpt.latest_step(a)
    replay = max(abs(x - y) for x, y in zip(losses[7:10], losses[4:7]))
    vs_clean = max(abs(x - y) for x, y in zip(losses[7:], want[4:]))
    log("train", f"train_loop on the card: {stats.steps_run} steps, "
        f"{stats.restores} restore; replayed losses vs first run "
        f"{replay:.3g}, after the restore vs an uninterrupted run "
        f"{vs_clean:.3g} (bound {TRAIN_LOOP_TOL}); a fresh loop resumed "
        f"for {resumed.steps_run} steps, latest checkpoint {latest}; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (stats.restores == 1 and stats.steps_run == 13
            and clean.steps_run == 10 and replay <= TRAIN_LOOP_TOL
            and vs_clean <= TRAIN_LOOP_TOL and resumed.steps_run == 4
            and latest == 13):
        raise AssertionError(f"train_loop on the card: {stats} {resumed} "
                             f"{latest} {replay} {vs_clean}")


def _train_step_profile(step, params, state, batch):
    """torch.profiler over one step: (wall ms with the profiler on, device
    busy ms, matrix-product share of device time, top kernels, the step's
    outputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(params, state, batch)
        float(out[2]["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, mm_share, top = _device_rows(prof)
    return wall, busy, mm_share, top[:6], out


def _train_step_split(bundle, opt, params, state, batch):
    """One train step timed in its two parts on the host clock, each
    ending in a synchronise: (loss and gradients ms, AdamW update ms)."""
    import torch
    from repro_torch.train.step import to_device
    batch = to_device(batch, bundle.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.update({n: g for (n, _), g in zip(params.named_parameters(), grads)},
               state, params)
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def train_full_width(smi: str) -> dict:
    """(d): Qwen3-32B at every published width, 4 of 64 layers, bf16
    params, fp32 moments, remat "full", global batch 2 x 2048 on
    learnable data; 5 steps of make_train_step, then one profiled
    big-batch step and one make_accum_train_step(accum=2) step from the
    same state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import HW
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_accum_train_step, make_train_step
    cfg = dataclasses.replace(get_config("qwen3_32b"), num_layers=4)
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg, remat="full", device="cuda")
    params = bundle.init(torch.Generator("cuda").manual_seed(SEED))
    opt = adamw(warmup_cosine(1e-3, 2, TRAIN_FULL_STEPS + 1))
    state = opt.init(params)
    step = make_train_step(bundle, opt)
    nparams = sum(p.numel() for p in params.parameters())
    n_flop = nparams - params["embed"]["tok"].numel()   # head included
    tokens = TRAIN_B * TRAIN_S
    flop_ms = 6 * n_flop * tokens / HW.PEAK_FLOPS_BF16 * 1e3
    opt_ms = TRAIN_OPT_BYTES * nparams / HW.HBM_BW * 1e3
    first = [p.detach().flatten()[:4096].clone() for p in params.parameters()]
    data = SyntheticLM(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=SEED,
                                       mode="learnable"))
    losses, gnorms, ms = [], [], []
    for _ in range(TRAIN_FULL_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(met["grad_norm"]))
    moved = sum(not torch.equal(a, p.detach().flatten()[:4096])
                for a, p in zip(first, params.parameters()))
    nleaves = len(first)
    del first
    step_ms = statistics.median(ms[1:])
    # the same state twice: a host copy of params and moments
    host = {"p": [p.detach().cpu() for p in params.parameters()],
            "m": {n: t.cpu() for n, t in state["m"].items()},
            "v": {n: t.cpu() for n, t in state["v"].items()},
            "step": state["step"].clone()}
    batch = next(data)
    wall, busy, mm_share, top, (params, state, big) = _train_step_profile(
        step, params, state, batch)
    big_params = [p.detach().cpu() for p in params.parameters()]
    with torch.no_grad():
        for p, h in zip(params.parameters(), host["p"]):
            p.copy_(h)
        for key in ("m", "v"):
            for n, t in state[key].items():
                t.copy_(host[key][n])
    state["step"] = host["step"]
    del host
    micro = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])
             for k, v in batch.items()}
    params, state, acc = make_accum_train_step(bundle, opt, 2)(
        params, state, micro)
    dloss = abs(float(big["loss"]) - float(acc["loss"]))
    dparam = max(float((p.detach().float() - h.to("cuda").float())
                       .abs().max())
                 for p, h in zip(params.parameters(), big_params))
    fwd_bwd_ms, update_ms = _train_step_split(bundle, opt, params, state,
                                              next(data))
    peak = torch.cuda.max_memory_allocated()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    finite = all(map(math.isfinite, losses + gnorms + [
        float(big["loss"]), float(acc["loss"]),
        float(big["grad_norm"]), float(acc["grad_norm"])]))
    bound_ms = max(flop_ms, opt_ms)
    row = {"name": cfg.name, "layers": cfg.num_layers, "params": nparams,
           "flop_params": n_flop, "tokens": tokens, "losses": losses,
           "grad_norms": gnorms, "step_ms": ms, "step_ms_p50": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "bound_ms": bound_ms,
           "flop_ms": flop_ms, "opt_ms": opt_ms, "peak_bytes": peak,
           "profiled_step_ms": wall, "device_busy_ms": busy,
           "matmul_share": mm_share, "accum_dloss": dloss,
           "accum_dparam": dparam, "leaves_moved": moved,
           "fwd_bwd_ms": fwd_bwd_ms, "update_ms": update_ms, "card": smi}
    log("train", f"{cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {nparams / 1e9:.3f} B params, bf16, fp32 moments, "
        f"remat full): batch {TRAIN_B} x {TRAIN_S}, losses "
        + ", ".join(f"{x:.4f}" for x in losses) + ", grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; step ms " + ", ".join(f"{x:.1f}" for x in ms)
        + f"; median of steps 2-{TRAIN_FULL_STEPS} {step_ms:.3f} ms, "
        f"{row['tokens_per_s']:.1f} tokens/s; bound {bound_ms:.3f} ms "
        f"({bound_ms / step_ms:.1%}) = max(6 N T / 989 TFLOP/s = "
        f"{flop_ms:.3f} ms with N = {n_flop / 1e9:.3f} B, T = {tokens}; "
        f"{TRAIN_OPT_BYTES} B x {nparams / 1e9:.3f} B params / 3.35 TB/s "
        f"= {opt_ms:.3f} ms); peak memory {peak / 1e9:.2f} GB of "
        f"{total_mem / 1e9:.2f}; {moved} of {nleaves} leaves moved; card {smi}")
    log("train", f"{cfg.name} profiled step: {wall:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({busy / wall:.1%}), matrix products "
        f"{mm_share:.1%} of device time; top: "
        + "; ".join(f"{k[:50]} x{c} {us / 1e3:.3f} ms" for us, k, c in top))
    log("train", f"{cfg.name} one more step in two timed parts: loss and "
        f"gradients {fwd_bwd_ms:.3f} ms, AdamW update {update_ms:.3f} ms "
        f"({update_ms / (fwd_bwd_ms + update_ms):.1%}; its bytes bound "
        f"{opt_ms:.3f} ms)")
    log("train", f"{cfg.name} accumulation over 2 microbatches vs one "
        f"big-batch step from the same state: loss {float(acc['loss']):.5f}"
        f" vs {float(big['loss']):.5f} (|d| {dloss:.3g}, bound "
        f"{TRAIN_ACCUM_TOL}), params max |d| {dparam:.3g} (bound "
        f"{TRAIN_ACCUM_PARAM_TOL})")
    if not (finite and moved and peak < total_mem
            and dloss < TRAIN_ACCUM_TOL
            and dparam < TRAIN_ACCUM_PARAM_TOL):
        raise AssertionError(f"{cfg.name} training: finite {finite}, "
                             f"moved {moved}, peak {peak}, accum {dloss} "
                             f"{dparam}")
    return row


def phase_train():
    """The LM scaffold's training path (repro_torch.optim, data, train,
    the autograd Functions in models/layers.py)."""
    import gc
    import torch
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    train_card_vs_cpu()
    train_functions()
    train_loop_card()
    gc.collect()
    torch.cuda.empty_cache()
    return train_full_width(card_name_power())


#: Phase 12 (sharded train): the sharded step (DTensor params on a
#: ('data', 'model') DeviceMesh) against the plain step. Reduced configs
#: in float32: the loss and grad norm within 1e-5 relative, each leaf of
#: the first step's gradients within 1e-4 of its largest magnitude (the
#: card's bound in phase 11), the params after 2 AdamW steps at lr 1e-3
#: within 2e-4 (lr / 5: Adam turns the few-ulp gradient differences of
#: another summation order into a fraction of lr where a gradient is
#: near eps; seamless_m4t_v2 moved by 9.9e-5 on four H100s). The full-width cells in bfloat16: on a (1, 1)
#: mesh the losses within 1e-5 relative and each param within 1e-4 plus
#: one bf16 rounding (2^-8 of its magnitude: the grad norm sums its
#: leaves in another order); across cards, where the products are split,
#: phase 11's bf16 bounds (losses 5e-2, params 3e-2).
SHARD_LOSS_RTOL, SHARD_GRAD_TOL, SHARD_PARAM_TOL = 1e-5, 1e-4, 2e-4
SHARD_BF16_ULP = 2.0 ** -8
SHARD_BF16_LOSS, SHARD_BF16_PARAM = 5e-2, 3e-2
#: Multi-card meshes of the reduced configs, and the full-width MoE cell:
#: Qwen3-235B-A22B cut to 2 of 94 layers, global batch 4 x 2048, 3 steps.
SHARD_MESHES = ((2, 2), (1, 4), (4, 1))
MOE_B, MOE_S, MOE_STEPS = 4, 2048, 3
#: The MoE cell's lr: the first 3 steps of a 1000-step warmup to 1e-3
#: (1e-6, 2e-6, 3e-6), as a run of this size would start. The meshes'
#: first losses differ by bf16 rounding of the split products and the
#: routing flips it causes (5.1e-3 measured); with lr far above a
#: warmup's first steps those flips and Adam's sign-like first updates
#: part the trajectories (measured on four H100s: step-3 losses 0.146
#: apart at phase 11's warmup to 1e-3, 0.552 at a constant 1e-4).
MOE_WARMUP = 1000
#: Steps of Qwen3-32B/4L on (1, 1) and of its plain step, from one init.
SHARD_FULL_STEPS = 4
#: launch.dryrun's estimate of a step's peak (its trace on a fake process
#: group of the same mesh) against max_memory_allocated over the real
#: steps from the placed state: within 10 %.
DRY_PEAK_RTOL = 0.10


def _mesh(shape, ranks=None):
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if ranks is None:
        return init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
    return DeviceMesh("cuda", torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _reduced_steps(arch, device, mesh=None, steps=TRAIN_ADAM_STEPS):
    """(first-step grads, [(loss, grad norm)], params) of the reduced
    config in float32, from the seed's weights, whole tensors."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.adamw import like_param
    from repro_torch.train import make_train_step
    from repro_torch.train.step import _value_and_grad, to_device
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    bundle = build_model(cfg, device=device)
    params = bundle.init(torch.Generator(device).manual_seed(SEED))
    if mesh is not None:
        param_shardings(mesh, params)
    batches = [make_batch(cfg, DataConfig(4, 16, seed=SEED), i)
               for i in range(steps)]
    named = dict(params.named_parameters())
    _, g = _value_and_grad(bundle, params, to_device(batches[0], device),
                           mesh)
    grads = {n: _whole(like_param(t, named[n])) for n, t in g.items()}
    del g
    opt = adamw(constant(TRAIN_ADAM_LR))
    step, st, mets = make_train_step(bundle, opt, mesh=mesh), None, []
    st = opt.init(params)
    for b in batches:
        params, st, met = step(params, st, b)
        mets.append((float(met["loss"]), float(met["grad_norm"])))
    return grads, mets, {n: _whole(p) for n, p in params.named_parameters()}


def _compare_reduced(arch, label, got, want):
    (g, m, p), (wg, wm, wp) = got, want
    dloss = max(max(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]))
                for a, b in zip(m, wm))
    dgrad = max(float((g[n] - w).abs().max())
                / max(float(w.abs().max()), 1e-30) for n, w in wg.items())
    dparam = max(float((p[n] - w).abs().max()) for n, w in wp.items())
    log("sharded", f"{arch} reduced f32 on {label} vs the plain step: loss "
        f"and grad norm {dloss:.3g} relative (bound {SHARD_LOSS_RTOL}), "
        f"grads {dgrad:.3g} of each leaf's max (bound {SHARD_GRAD_TOL}), "
        f"params after {len(m)} AdamW steps {dparam:.3g} (bound "
        f"{SHARD_PARAM_TOL})")
    if not (dloss <= SHARD_LOSS_RTOL and dgrad <= SHARD_GRAD_TOL
            and dparam <= SHARD_PARAM_TOL):
        raise AssertionError(f"{arch} on {label}: {dloss} {dgrad} {dparam}")


def _full_width_steps(cfg, B, S, steps, mesh=None, device="cuda",
                      keep=True, lr=None, counted=None):
    """``steps`` steps of phase 11 (d)'s setup (bf16 params, fp32
    moments, remat full, learnable data; lr ``warmup_cosine(1e-3, 2,
    steps + 1)`` unless ``lr`` is given) from the seed's weights:
    (losses, grad norms, step ms, the params whole on the host (None
    unless ``keep``), peak bytes over the steps from the placed state).
    With a dict ``counted``, the first step runs under
    ``op_cost.CollectiveCounter`` and its counts and result bytes by kind
    go there (``counts``, ``raw``)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.op_cost import CollectiveCounter
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step
    bundle = build_model(cfg, remat="full", device=device)
    params = bundle.init(torch.Generator(device).manual_seed(SEED))
    if mesh is not None:
        param_shardings(mesh, params)
    opt = adamw(lr or warmup_cosine(1e-3, 2, steps + 1))
    state = opt.init(params)
    step = make_train_step(bundle, opt, mesh=mesh)
    data = SyntheticLM(cfg, DataConfig(B, S, seed=SEED, mode="learnable"))
    losses, gnorms, ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = next(data)
        count = (CollectiveCounter(mesh) if counted is not None and i == 0
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count:
            params, state, met = step(params, state, batch)
        if isinstance(count, CollectiveCounter):
            counted.update(counts=count.counts, raw=count.raw)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    host = ({n: _whole(p).cpu() for n, p in params.named_parameters()}
            if keep else None)
    del params, state, step, bundle
    torch.cuda.empty_cache()
    return losses, gnorms, ms, host, peak


def _param_gap(got, want):
    """(max |d|, max |d| - 2^-8 |want|) over every leaf (on the card)."""
    import torch
    gap = ulp = 0.0
    for n, w in want.items():
        w = w.to("cuda").float()
        d = (got[n].to("cuda").float() - w).abs()
        gap = max(gap, float(d.max()))
        ulp = max(ulp, float((d - SHARD_BF16_ULP * w.abs()).max()))
    return gap, ulp


def dryrun_estimate(cfg, B, S, shape):
    """launch.dryrun's trace of the train step of ``cfg`` at batch B x S
    on a fake process group of the (data, model) mesh ``shape`` (this
    process must hold no process group): the peak bytes a card, t_bound
    (the cards of one node: every axis on NVLink), collectives by kind,
    the trace's seconds."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import meta_params, model_flops, trace_step
    spec = ShapeSpec("chip", S, B, "train")
    cost, peak, secs = trace_step(cfg, spec, {"data": shape[0],
                                              "model": shape[1]})
    rl = RL.analyze(cost, peak, shape[0] * shape[1],
                    model_flops(cfg, meta_params(cfg), spec),
                    node_axes=("data", "model"))
    return {"peak": peak, "t_bound_ms": rl.t_bound * 1e3,
            "bottleneck": rl.bottleneck, "counts": cost.coll_count,
            "raw": cost.coll_raw, "secs": secs}


def _check_estimate(what, est, peak, step_ms, counted=None):
    """The estimate's peak within DRY_PEAK_RTOL of the measured one, and
    with ``counted`` (the real step's CollectiveCounter) the collective
    counts equal by kind."""
    rel = est["peak"] / peak - 1
    line = (f"{what}: dry-run trace ({est['secs']:.1f} s on the host) peak "
            f"{est['peak'] / 1e9:.2f} GB a card vs max_memory_allocated "
            f"{peak / 1e9:.2f} GB ({rel:+.1%}, bound {DRY_PEAK_RTOL:.0%}); "
            f"t_bound {est['t_bound_ms']:.1f} ms ({est['bottleneck']}) vs "
            f"the measured step {step_ms:.1f} ms")
    same = True
    if counted is not None:
        kinds = [k for k in est["counts"] if est["counts"][k]
                 or counted["counts"][k]]
        same = all(est["counts"][k] == counted["counts"][k] for k in kinds)
        line += "; collectives (trace / CommDebugMode-with-bytes on nccl): " \
            + ", ".join(f"{k} {est['counts'][k]:.0f}/"
                        f"{counted['counts'][k]:.0f} ("
                        f"{est['raw'][k] / 1e9:.3f}/"
                        f"{counted['raw'][k] / 1e9:.3f} GB)" for k in kinds)
    log("sharded", f"{line}; card {card_name_power()}")
    if abs(rel) > DRY_PEAK_RTOL or not same:
        raise AssertionError(f"{what}: the dry run's estimate misses: "
                             f"{est} vs peak {peak}, {counted}")


def sharded_world1():
    """The one-card checks on an in-process nccl group of world 1 (a
    FileStore in a temporary directory) and a (1, 1) mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCH_IDS, get_config
    cfg = dataclasses.replace(get_config("qwen3_32b"), num_layers=4)
    est = dryrun_estimate(cfg, TRAIN_B, TRAIN_S, (1, 1))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{d}/store", 1), rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = _mesh((1, 1))
            for arch in ARCH_IDS:
                _compare_reduced(arch, "(1, 1)",
                                 _reduced_steps(arch, "cuda", mesh),
                                 _reduced_steps(arch, "cuda"))
            n = SHARD_FULL_STEPS
            sl, sg, sms, sp, speak = _full_width_steps(
                cfg, TRAIN_B, TRAIN_S, n, mesh)
            pl, pg, pms, pp, ppeak = _full_width_steps(
                cfg, TRAIN_B, TRAIN_S, n)
            dloss = max(abs(a - b) / abs(b) for a, b in zip(sl, pl))
            gap, ulp = _param_gap(sp, pp)
            del sp, pp
            s_med, p_med = statistics.median(sms[1:]), statistics.median(
                pms[1:])
            log("sharded", f"{cfg.name} ({cfg.num_layers} layers, full "
                f"width, bf16, remat full, batch {TRAIN_B} x {TRAIN_S}) on "
                f"(1, 1) vs the plain step from the same init: losses "
                + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(sl, pl))
                + f" within {dloss:.3g} relative (bound {SHARD_LOSS_RTOL}); "
                f"params after {n} steps max |d| {gap:.3g} (bound "
                f"{SHARD_PARAM_TOL} + 2^-8 |p|: excess {ulp:.3g}); step ms "
                f"sharded " + ", ".join(f"{x:.1f}" for x in sms)
                + ", plain " + ", ".join(f"{x:.1f}" for x in pms)
                + f"; median of steps 2-{n}: sharded {s_med:.1f}, plain "
                f"{p_med:.1f} (DTensor's overhead {s_med - p_med:.1f} ms, "
                f"{s_med / p_med - 1:.1%}); peak {speak / 1e9:.2f} / "
                f"{ppeak / 1e9:.2f} GB; card {card_name_power()}")
            if not (dloss <= SHARD_LOSS_RTOL and ulp <= SHARD_PARAM_TOL
                    and all(map(math.isfinite, sl + sg))):
                raise AssertionError(f"{cfg.name} on (1, 1): {dloss} {ulp}")
            _check_estimate(f"{cfg.name}/4L on (1, 1), batch {TRAIN_B} x "
                            f"{TRAIN_S}", est, speak, s_med)
            compressed_world1(mesh)
        finally:
            dist.destroy_process_group()


def compressed_world1(mesh):
    """make_compressed_train_step at world 1 on the reduced qwen3: a
    finite loss; compressed_grads' g_hat equals q * scale; the error
    feedback is nonzero."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed.compress import (compressed_grads, init_ef,
                                                  make_compressed_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              dtype="float32")
    bundle = build_model(cfg, device="cuda")
    params = bundle.init(torch.Generator("cuda").manual_seed(SEED))
    dp = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    opt = adamw(constant(TRAIN_ADAM_LR))
    step = make_compressed_train_step(bundle.loss, opt, dp)
    _, _, ef, met = step(params, opt.init(params), init_ef(params),
                         make_batch(cfg, DataConfig(4, 16, seed=SEED), 0))
    g = {"w": torch.randn(4096, generator=torch.Generator("cuda")
                          .manual_seed(SEED), device="cuda") * 1e-3}
    gh, ef1 = compressed_grads(g, {"w": torch.zeros_like(g["w"])})
    scale = torch.clamp(g["w"].abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g["w"] / scale), -127, 127).to(torch.int8)
    exact = torch.equal(gh["w"], q.float() * scale)
    nonzero = all(bool(e.abs().max() > 0) for e in ef.values())
    loss = float(met["loss"])
    log("sharded", f"compressed DP step at world 1 (reduced qwen3 f32): "
        f"loss {loss:.5f}; g_hat == q * scale: {exact}; error feedback "
        f"nonzero on every leaf: {nonzero} (max |ef| "
        f"{float(ef1['w'].abs().max()):.3g} on a 4096-vector)")
    if not (math.isfinite(loss) and exact and nonzero):
        raise AssertionError(f"compressed step: {loss} {exact} {nonzero}")


def _gather_peaks(peak):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, peak)
    return out


def _moe_cell(rank, shape, cfg):
    """MOE_STEPS steps of the full-width MoE cell on ``shape`` at the
    start of a MOE_WARMUP-step warmup: losses, grad norms, step ms, peak
    bytes per card, and the first step's collectives on this rank."""
    mesh = _mesh(shape)
    from repro_torch.optim import warmup_cosine
    counted = {}
    losses, gnorms, ms, _, peak = _full_width_steps(
        cfg, MOE_B, MOE_S, MOE_STEPS, mesh, f"cuda:{rank}", keep=False,
        lr=warmup_cosine(1e-3, MOE_WARMUP, 10 * MOE_WARMUP),
        counted=counted)
    return losses, gnorms, ms, _gather_peaks(peak), counted


def _elastic_card(rank, ckpt_dir):
    """Two steps of the reduced qwen3 (float32) on (2, 2), a checkpoint,
    the next step there; then elastic_rescale onto (2, 1) over cards 0-1
    and the same next step there: (loss on (2, 2), loss on (2, 1))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.distributed.sharding import (param_shardings,
                                                  state_shardings)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import elastic_rescale
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              dtype="float32")
    mesh, sub = _mesh((2, 2)), _mesh((2, 1), [[0], [1]])
    bundle = build_model(cfg, device="cuda")
    params = param_shardings(mesh, bundle.init(
        torch.Generator("cuda").manual_seed(SEED)))
    opt = adamw(constant(TRAIN_ADAM_LR))
    p, o = params, opt.init(params)
    step = make_train_step(bundle, opt, mesh=mesh)
    b = [make_batch(cfg, DataConfig(4, 16, seed=SEED), i) for i in range(3)]
    for i in range(2):
        p, o, _ = step(p, o, b[i])
    state = {"params": p, "opt": o}
    ckpt.save(ckpt_dir, 1, state)
    _, _, met = step(p, o, b[2])
    ref = float(met["loss"])
    state = ckpt.restore(ckpt_dir, 1, state)
    got = elastic_rescale(state, sub, state_shardings)
    if got is None:
        return ref, None
    _, _, met = make_train_step(bundle, opt, mesh=sub)(
        got["params"], got["opt"], b[2])
    return ref, float(met["loss"])


def _sharded_worker(rank, world, store, ckpt_dir, estimates):
    """One card a rank: the multi-card checks; rank 0 logs them."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    say = (lambda m: log("sharded", m)) if rank == 0 else (lambda m: None)
    try:
        from repro_torch.configs import ARCH_IDS, get_config
        from repro_torch.launch.dryrun import active_params, meta_params
        from repro_torch.launch.mesh import HW
        want = {}
        for shape in SHARD_MESHES:
            if world < shape[0] * shape[1]:
                say(f"reduced configs on {shape} skipped: needs "
                    f"{shape[0] * shape[1]} cards, {world} present")
                continue
            mesh = _mesh(shape)
            for arch in ARCH_IDS:
                got = _reduced_steps(arch, f"cuda:{rank}", mesh)
                if rank == 0:
                    if arch not in want:
                        want[arch] = _reduced_steps(arch, "cuda:0")
                    _compare_reduced(arch, str(shape), got, want[arch])
            dist.barrier()
        if world < 4:
            say(f"Qwen3-32B/4L on (2, 2), Qwen3-235B-A22B on (1, 4) and "
                f"(2, 2) and the elastic rescale skipped: need 4 cards, "
                f"{world} present")
            return
        cfg = dataclasses.replace(get_config("qwen3_32b"), num_layers=4)
        n = TRAIN_ADAM_STEPS
        sl, _, sms, sp, speak = _full_width_steps(
            cfg, TRAIN_B, TRAIN_S, n, _mesh((2, 2)), f"cuda:{rank}")
        peaks = _gather_peaks(speak)
        if rank == 0:
            pl, _, pms, pp, _ = _full_width_steps(cfg, TRAIN_B, TRAIN_S, n)
            dloss = max(abs(a - b) for a, b in zip(sl, pl))
            gap, _ = _param_gap(sp, pp)
            say(f"{cfg.name} (4 layers, full width, bf16) on (2, 2) vs the "
                f"plain step on one card: losses "
                + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(sl, pl))
                + f" (max |d| {dloss:.3g}, bound {SHARD_BF16_LOSS}); params "
                f"after {n} steps max |d| {gap:.3g} (bound "
                f"{SHARD_BF16_PARAM}); step ms " + ", ".join(f"{x:.1f}" for x in sms)
                + " vs " + ", ".join(f"{x:.1f}" for x in pms) + "; peak per "
                f"card {[round(x / 1e9, 2) for x in peaks]} GB")
            if not (dloss <= SHARD_BF16_LOSS and gap <= SHARD_BF16_PARAM):
                raise AssertionError(f"{cfg.name} on (2, 2): {dloss} {gap}")
        del sp
        dist.barrier()
        torch.cuda.empty_cache()
        moe = dataclasses.replace(get_config("qwen3_moe_235b"), num_layers=2)
        meta = meta_params(moe)
        active = active_params(meta, moe)
        nparams = sum(p.numel() for p in meta.parameters())
        tokens = MOE_B * MOE_S
        bound_ms = 6 * active * tokens / (4 * HW.PEAK_FLOPS_BF16) * 1e3
        cells = {}
        for shape in ((1, 4), (2, 2)):
            losses, gnorms, ms, peaks, counted = _moe_cell(rank, shape, moe)
            cells[shape] = losses
            med = statistics.median(ms[1:])
            say(f"{moe.name} (2 of 94 layers, full width: d_model "
                f"{moe.d_model}, {moe.moe.num_experts} experts top-"
                f"{moe.moe.top_k}, d_ff_expert {moe.moe.d_ff_expert}, vocab "
                f"{moe.vocab}; {nparams / 1e9:.3f} B params, state "
                f"{12 * nparams / 1e9:.1f} GB, {12 * nparams / 4e9:.1f} GB "
                f"a card) bf16 on {shape}, batch {MOE_B} x {MOE_S}: losses "
                + ", ".join(f"{x:.5f}" for x in losses) + ", grad norms "
                + ", ".join(f"{x:.3f}" for x in gnorms) + f"; step ms "
                + ", ".join(f"{x:.1f}" for x in ms) + f"; median of steps "
                f"2-{MOE_STEPS} {med:.1f} ms, {tokens / med * 1e3:.1f} "
                f"tokens/s; bound 6 x {active / 1e9:.3f} B active x {tokens}"
                f" / (4 x 989 TFLOP/s) = {bound_ms:.2f} ms "
                f"({bound_ms / med:.1%}); peak per card "
                f"{[round(x / 1e9, 2) for x in peaks]} GB; card "
                f"{card_name_power()}")
            if not (all(map(math.isfinite, losses + gnorms))
                    and max(peaks) < HW.HBM_BYTES):
                raise AssertionError(f"{moe.name} on {shape}: {losses} "
                                     f"{peaks}")
            if rank == 0:
                _check_estimate(f"{moe.name}/2L on {shape}, batch {MOE_B} x "
                                f"{MOE_S}, card 0", estimates[shape],
                                peaks[0], med, counted)
            dist.barrier()
            torch.cuda.empty_cache()
        d = max(abs(a - b) for a, b in zip(cells[(1, 4)], cells[(2, 2)]))
        say(f"{moe.name}: losses on (1, 4) and (2, 2) within {d:.3g} (bound "
            f"{SHARD_BF16_LOSS})")
        if d > SHARD_BF16_LOSS:
            raise AssertionError(f"{moe.name}: meshes disagree by {d}")
        ref, got = _elastic_card(rank, ckpt_dir)
        if rank == 0:
            rel = abs(got - ref) / abs(ref)
            say(f"elastic rescale (reduced qwen3 f32): 2 steps on (2, 2), "
                f"checkpoint, next loss {ref:.6f}; elastic_rescale onto "
                f"(2, 1) over cards 0-1, the same step: {got:.6f} "
                f"({rel:.3g} relative, bound {SHARD_LOSS_RTOL})")
            if rel > SHARD_LOSS_RTOL:
                raise AssertionError(f"elastic rescale: {ref} vs {got}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_sharded():
    """12. sharded train: the one-card checks in this process, then one
    process a card for the multi-card checks (each skipped, with a line,
    when the machine has too few cards)."""
    import gc
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    sharded_world1()
    world = torch.cuda.device_count()
    estimates = {}
    if world >= 4:                     # traced here: no process group yet
        from repro_torch.configs import get_config
        moe = dataclasses.replace(get_config("qwen3_moe_235b"), num_layers=2)
        estimates = {shape: dryrun_estimate(moe, MOE_B, MOE_S, shape)
                     for shape in ((1, 4), (2, 2))}
    if world < 2:
        log("sharded", f"multi-card checks skipped: the reduced configs on "
            f"{', '.join(map(str, SHARD_MESHES))}, Qwen3-32B/4L on (2, 2), "
            f"Qwen3-235B-A22B/2L on (1, 4) and (2, 2) and the elastic "
            f"rescale need 2 or 4 cards, {world} present")
        return
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_sharded_worker, args=(world, f"{d}/store", f"{d}/ckpt",
                                        estimates), nprocs=world)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL: no src/repro_torch beside {Path(__file__).name}",
              flush=True)
        return 2
    sys.path.insert(0, str(SRC))
    torch.manual_seed(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_device()
    if argv == ["--sharded"]:              # phase 12 alone, on every card
        phase_sharded()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase_build()
    phase_parity(gen)
    launches, frames, rx = phase_main(gen)
    wide_launches = phase_main_wide(gen)
    large_launches = phase_main_large(gen)
    lowrate_launches = phase_main_lowrate(gen)
    entries, call_ms = phase_time(frames, rx, launches, gen)
    phase_profile(rx, call_ms)
    stream = phase_stream(gen)
    serve = phase_serve(gen)
    mesh = phase_mesh(gen, frames)
    phase_lm()
    phase_train()
    phase_sharded()
    for entry in entries:
        entry["launches_stream"] = stream[entry["name"]]
        entry["launches_serve"] = serve[entry["name"]]
        entry["launches_mesh"] = mesh[entry["name"]]
        entry["launches_wide"] = wide_launches[entry["name"]]
        entry["launches_large"] = large_launches[entry["name"]]
        entry["launches_lowrate"] = lowrate_launches[entry["name"]]
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"JAX-side modules were imported: {bad[:5]}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
