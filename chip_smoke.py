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
             spills of every instantiation (registers per lane R x beta).
3. parity  — each kernel's wrapper against its plain torch version on the
             card, exactly (torch.equal), over the codes K=3, 4 (beta=3),
             5, 6, 7, 9, 11 and the large codes K=12, 13, 15 (beta=4;
             one block a frame, path metrics in shared memory). Unified
             kernel: the knob grid, bf16/f16 LLRs, frames too long for
             shared memory. Forward kernel: sel and amax over the same
             grid, both layouts. Traceback kernel: against the plain
             serial/parallel chase over the forward kernel's outputs, and
             both of its chases (staged, direct) pinned at K=7 and K=11
             on a sliced stream. Both paths through ops with a ragged
             frame count. The block-parallel decode (block_frames > 1)
             through both kernels against the CPU's, and at full overlap
             against the unblocked decode.
4. main    — make_decoder(backend="kernel"), then
             make_decoder(backend="kernel_split"), each at full size: K=7,
             n = 2^22 bits, Eb/N0 = 3 dB, rates 1/2 and 3/4. Launch counts
             are set to 0 just before each path and read just after (split:
             one forward and one traceback launch per call, no unified
             launch); the bits must equal backend="reference" on the same
             LLRs (and the split bits the unified bits), and the rate-1/2
             BER must be below 1e-3.
5. time    — each kernel at the main path's shape with CUDA events, beside
             its plain version and its bound; the unified kernel's knob
             sweep and its auto tile against tile 4 (must be within 2 %);
             the split path's layouts; the traceback's staged and direct
             chases in turns, at K=7 (lane and sublane, packed, unpacked,
             serial) and K=11 (4096 frames), beside the shape rule's pick
             and the bound; B1 and B3 at K=12, 13, 15 beside their bounds;
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
             bits pushed in seeded random slices of 1-64 kbit (raw
             symbols at rate 3/4, so slices cut puncturing periods), at the
             one-wave chunk (the plan's resident frames per SM x SMs),
             then n = 2^18 at the planner's default chunk. Launch counts
             set to 0 just before each run and read just after: B1 once
             per chunk, nothing else. Bits must equal make_decoder on the
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

The line before the last is a JSON `kernels` line (with each kernel's
launches on the main path, and ``launches_stream``/``launches_serve``/
``launches_mesh`` on phases 7, 8 and 9; B1's and B3's ``large_codes``
times and the traceback's ``modes``); each kernel's bound comes from
launch/roofline.py. The last line is the JSON `ok` line with the device.
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
#: then the large-code mapping (one block of 1024 threads a frame, path
#: metrics in shared memory): K=12 (R=2), K=13 (R=4), the Galileo (15, 1/4)
#: code (R=16), K=14 (R=8) and a K=12 rate-1/8 code (beta 8: four warps
#: build the branch-metric table).
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
#: Frames of the large codes' timing (one and two waves of one frame per
#: SM at 132 SMs): K=12 and K=13 at 264, K=14 and K=15 at 132.
LARGE_TIME_FRAMES = {12: 264, 13: 264, 14: 132, 15: 132}
DECODE_KERNELS = ("viterbi_unified_kernel", "viterbi_fwd_kernel",
                  "traceback_frames_kernel", "viterbi_unified_smem_kernel",
                  "viterbi_fwd_smem_kernel")


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
    instantiation of one ACS kernel: per registers per lane R, beta 2..8;
    then the large-code mapping's (``<kernel>`` with ``_smem`` before
    ``_kernel``), one R per k = 12..15."""
    import ctypes
    smem_kernel = kernel.replace("_kernel", "_smem_kernel")
    spills = _ptxas_spills(built, kernel)
    smem_spills = _ptxas_spills(built, smem_kernel)
    rows = []
    for k in (2, 7, 8, 9, 10, 11, 12, 13, 14, 15):
        large = k >= 12                     # R = S / 1024 states a thread
        R = (1 << (k - 1)) // 1024 if large else max(1, (1 << (k - 1)) // 32)
        regs = []
        for beta in range(2, 9):
            out = (ctypes.c_int * 3)()
            if attrs(k, beta, out) != 0:
                raise RuntimeError(f"{kernel} k={k} beta={beta}: no "
                                   f"function attributes")
            sp = (smem_spills if large else spills).get((R, beta), "?")
            regs.append(f"{out[0]}/{sp}")
        rows.append(f"{f'k={k} ' if large else ''}R={R}: " + " ".join(regs))
    return (f"{kernel} registers/spilled bytes, beta 2..8 (R=1 serves "
            f"k<=6; k=12..15: {smem_kernel}, 1024 threads): "
            + "; ".join(rows))


def phase_build():
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    libs = {"viterbi_unified_kernel": vu.kernel_library,
            "viterbi_fwd_kernel": vf.kernel_library,
            "traceback_frames_kernel": tbf.kernel_library}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in libs.items()}
        built = {k: fut.result() for k, fut in futures.items()}
    wall = time.perf_counter() - t0
    for kernel, b in built.items():
        log("build", f"{b.path.name} nvcc {b.seconds:.1f} s")
    log("build", f"all {len(built)} sources in {wall:.1f} s (parallel)")
    for kernel, attrs in (("viterbi_unified_kernel",
                           "viterbi_unified_func_attrs"),
                          ("viterbi_fwd_kernel", "viterbi_fwd_func_attrs")):
        log("build", register_report(built[kernel], kernel,
                                     getattr(built[kernel].lib, attrs)))


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
    for k, polys in CODES:
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
    for k, polys in CODES:
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
                tr.k, long_spec.frame_len, 1, int(pack), 0, 1, 0) > \
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
    blocked = phase_blocked(gen)
    log("parity", f"kernel calls equal to the plain version: {counts} "
        f"(codes K=3, K=4 beta=3, K=5, K=6, K=7, K=9, K=11, K=12, K=13, "
        f"K=15 beta=4, K=14, K=12 beta=8; pack x radix x layout x "
        f"bm_dtype; serial, boundary, fixed; bf16/f16 LLRs; device-memory "
        f"survivors at K=7, K=11, K=13 and K=15; the traceback's staged and "
        f"direct chase at K=7 and K=11); split and unified ops with a "
        f"ragged F equal to the CPU for every code; {blocked}")


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
    from repro_torch.kernels import traceback_frames as tbf
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    return {"viterbi_unified": vu.unified_decode_frames_cuda,
            "viterbi_fwd": vf.forward_frames_cuda,
            "traceback_frames": tbf.traceback_frames_cuda}


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
    split, scounts, swall = _drive("kernel_split", streams)
    want = {"viterbi_unified": 0, "viterbi_fwd": 2, "traceback_frames": 2}
    if scounts != want:
        raise AssertionError(f"split path launches {scounts}, expected "
                             f"{want} (one forward and one traceback launch "
                             f"per call, no unified launch)")
    for rate, (bits, rx) in streams.items():
        ref = make_decoder(main_config(rate, "reference"), "cuda")(rx, N_BITS)
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
    log("main", f"backend=kernel launches {ucounts}, both rates in "
        f"{uwall * 1e3:.1f} ms; backend=kernel_split launches {scounts}, "
        f"both rates in {swall * 1e3:.1f} ms (host clock, after synchronize, "
        f"first calls)")
    rx = streams["1/2"][1]
    spec = main_config("1/2", "kernel").spec
    frames = frame_llr(depuncture(rx, "1/2", N_BITS), spec).contiguous()
    launches = {"viterbi_unified": ucounts["viterbi_unified"],
                "viterbi_fwd": scounts["viterbi_fwd"],
                "traceback_frames": scounts["traceback_frames"]}
    return launches, frames, rx


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
    return {"name": "viterbi_unified", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/viterbi_unified.cu",
            "replaces": "src/repro/kernels/viterbi_unified.py:199",
            "launches": launches["viterbi_unified"], "max_abs_err": err,
            "parity": "equal", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    K=14, K=12 beta=8) on the main path's frame, packed, radix 4: bits and
    streams equal the plain versions; ms per launch beside the bound (CUDA
    events).
    Returns {name: [{k, beta, F, ms, bound_ms, bound_by}, ...]}."""
    import torch
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu
    spec = main_config("1/2", "kernel").spec
    out = {"viterbi_unified": [], "viterbi_fwd": []}
    for code in CODES:
        if code[0] < LARGE_K:
            continue
        tr = make_trellis(*code)
        F = LARGE_TIME_FRAMES[tr.k]
        frames = _frames(tr, spec, F, gen, torch.float32)
        kw = dict(trellis=tr, v1=20, f=256, v2=45, f0=32, v2s=45,
                  frames_per_tile=1, pack_survivors=True, radix=4)
        fkw = dict(trellis=tr, frames_per_tile=1, pack_survivors=True,
                   radix=4)
        _check_equal(vu.unified_decode_frames_cuda(frames, **kw),
                     vu.unified_decode_frames_plain(frames, **kw),
                     f"unified k={tr.k} main frame")
        _check_equal(vf.forward_frames_cuda(frames, **fkw),
                     vf.forward_frames_plain(frames, **fkw),
                     f"forward k={tr.k} main frame")
        ms = _interleaved({
            "viterbi_unified": lambda: vu.unified_decode_frames_cuda(
                frames, **kw),
            "viterbi_fwd": lambda: vf.forward_frames_cuda(frames, **fkw)},
            3, rounds=2)
        plan = autotune.plan_tiles(tr, spec, pack_survivors=True,
                                   device="cuda")
        for name in out:
            b = bound(name, spec, F, trellis=tr)
            out[name].append({"k": tr.k, "beta": tr.beta, "F": F,
                              "ms": ms[name], "bound_ms": b[0],
                              "bound_by": b[1]})
        where = ("on chip" if dict(plan.breakdown)["sel_survivors"]
                 else "in device scratch")
        log("time", f"large code K={tr.k} beta={tr.beta} F={F} L="
            f"{spec.frame_len} (one block of 1024 threads a frame; unified "
            f"survivors {where}, "
            f"{plan.smem_bytes} B smem, {plan.registers} registers): "
            + "; ".join(f"{n} {ms[n]:.4f} ms, bound "
                        f"{out[n][-1]['bound_ms']:.4f} ms "
                        f"({out[n][-1]['bound_by']}, "
                        f"{out[n][-1]['bound_ms'] / ms[n]:.1%})"
                        for n in out))
        del frames
    return out


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
    large = time_large_codes(gen)
    unified["large_codes"] = large["viterbi_unified"]
    split["fwd"]["large_codes"] = large["viterbi_fwd"]
    calls = time_end_to_end(rx_half)
    time_planner(frames)
    return [unified, split["fwd"], split["tb"]], calls


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
        kind = ("B1" if "viterbi_unified_kernel" in ev.key else
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
    dec.push(src[:chunk * cfg.spec.f])          # builds the programs
    dec.flush()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e8))                 # ~0.25 s of spinning
    t0 = time.perf_counter()
    dec._ctx.append(src[:need])
    w0, w1 = dec._ctx.take_windows()
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
        for n, chunk, label in ((STREAM_BITS, wave, "one wave"),
                                (STREAM_SMALL_BITS, plan.chunk_frames,
                                 "default")):
            _, rx = channel(gen, n, EBN0_DB, rate)
            want = make_decoder(cfg, "cuda")(rx, n).cpu().numpy()
            rx_host = rx.cpu().numpy()
            bits, wall, host, counts, pushes, _ = _stream_run(
                cfg, rx_host, n, chunk, rng)
            chunks = host["chunks"]
            if counts != {"viterbi_unified": chunks, "viterbi_fwd": 0,
                          "traceback_frames": 0}:
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
                  "traceback_frames": 0}:
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
                  "traceback_frames": launches} or len(srv.buckets()) != 1:
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
    want = {"viterbi_unified": n, "viterbi_fwd": 0, "traceback_frames": 0}
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
