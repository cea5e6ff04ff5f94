#!/usr/bin/env python3
"""Time variants of the shared ACS recursion (csrc/acs.cuh) on one card.

    python3 tools/acs_variants.py [--rounds 10] [--reps 10] [--frames 16384]
                                  [--json FILE]

Run from the root of a checkout on a machine with an NVIDIA Hopper card,
`nvcc` and PyTorch built for CUDA. Each variant is the port's own
`csrc/` with a few textual edits (VARIANTS below), built into
`build/variants/<name>/` with the port's nvcc flags. Every variant is
instantiated for beta = 2, 3 only and for R = 1, 2, 8, 16, 32 registers
per lane (k <= 6, 7, 9, 10, 11), so that all of them build in seconds.
Then, per workload, the unified kernel (B1) and the forward kernel (B3)
of every variant run in turns (a, b, ..., b, a) for ``--rounds`` rounds
of ``--reps`` launches each, through the port's own wrappers, at tile 4,
packed survivors, radix 4, lane layout, on the same noisy frames.
Every variant's outputs must equal the plain version's on a few frames
and the first variant's at the timed shape.

It prints, per workload, kernel and variant, the median, quartiles and
min of the ms per launch, and the registers (cudaFuncGetAttributes) and
spilled bytes (ptxas) of the instantiation; the same as JSON in
build/variants/acs_variants.json (``--json`` names another file).

The variants are the alternatives to two choices acs.cuh makes:

* ``asis``          — the code as it stands: each edge's branch metric an
                      fma chain over float sign registers; the kernels
                      inline one loop per bm_dtype.
* ``sign_bits``     — the signs as bits, one word a register, each term
                      negated by a select before its add.
* ``bf16_runtime``  — one loop for both bm_dtypes, the bf16 rounding
                      behind a runtime flag.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
OUT_DIR = ROOT / "build" / "variants"
SOURCES = ("viterbi_unified.cu", "viterbi_fwd.cu")
SPECIALISED = """    if (p.bf16_bm)        // one inlined loop per bm_dtype
      vit_recursion(fr, p.llr, p.llr_dtype, true, base, p.L, fvalid, st);
    else
      vit_recursion(fr, p.llr, p.llr_dtype, false, base, p.L, fvalid, st);
"""
RUNTIME = ("    vit_recursion(fr, p.llr, p.llr_dtype, p.bf16_bm != 0, base, "
           "p.L, fvalid, st);\n")
# Every variant: beta = 2, 3 only (no run-time beta), and R = 1, 2, 8, 16,
# 32 only.
COMMON = [
    ("acs.cuh", """    case 4: return F::template run<R, 4>(a...);
    case 5: return F::template run<R, 5>(a...);
    case 6: return F::template run<R, 6>(a...);
    case 7: return F::template run<R, 7>(a...);
    case 8: return F::template run<R, 8>(a...);
    default: return F::template run<R, 0>(a...);""",
     "    default: return F::template run<R, 3>(a...);"),
    ("acs.cuh", "    case 4: return vit_dispatch_beta<F, 4>(beta, a...);\n",
     ""),
]
# Sign bits: one word a register, bit 8p + b set when term b of edge p is
# negated, each term negated by a select before its add.
SIGN_BITS = [
    ("acs.cuh", "  float sg[R][2][BETA];",
     "  unsigned neg[R];"),
    ("acs.cuh", """        for (int b = 0; b < BETA; ++b)
          sg[r][p][b] = e * signs_half[h * BETA + b];       // +-1
""", """        for (int b = 0; b < BETA; ++b)
          neg[r] = (p == 0 && b == 0 ? 0u : neg[r]) |
                   (e * signs_half[h * BETA + b] < 0.f ? 1u : 0u)
                       << (8 * p + b);
"""),
    ("acs.cuh", """    float acc = __fmul_rn(sg[r][p][0], x[0]);
#pragma unroll
    for (int b = 1; b < BETA; ++b) acc = __fmaf_rn(sg[r][p][b], x[b], acc);
""", """    const unsigned m = neg[r] >> (8 * p);
    float acc = (m & 1u) ? -x[0] : x[0];
#pragma unroll
    for (int b = 1; b < BETA; ++b)
      acc = __fadd_rn(acc, ((m >> b) & 1u) ? -x[b] : x[b]);
"""),
]
VARIANTS = {
    "asis": [],
    "sign_bits": SIGN_BITS,
    "bf16_runtime": [(s, SPECIALISED, RUNTIME) for s in SOURCES],
}
#: (name, k, polynomials, bm_dtype)
WORKLOADS = [("K5_f32", 5, (0o23, 0o35), "float32"),
             ("K7_f32", 7, (0o171, 0o133), "float32"),
             ("K7_bf16", 7, (0o171, 0o133), "bfloat16"),
             ("K9_f32", 9, (0o753, 0o561), "float32"),
             ("K9b3_f32", 9, (0o557, 0o663, 0o711), "float32"),
             ("K10_f32", 10, (0o1167, 0o1545), "float32"),
             ("K11_f32", 11, (0o3345, 0o3613), "float32")]


def make_variant(name: str, edits) -> Path:
    """csrc/ with the common and the variant's edits, in OUT_DIR/name."""
    from repro_torch.kernels.build import CSRC
    dst = OUT_DIR / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for fname, old, new in COMMON + edits:
        p = dst / fname
        text = p.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit of {fname} does not "
                               f"apply once: {old.strip()[:60]!r}")
        p.write_text(text.replace(old, new))
    return dst


def nvcc(src: Path):
    """Build one variant source; returns build.Built."""
    from repro_torch.kernels.build import NVCC_FLAGS, Built, nvcc_path
    out = src.with_suffix(".so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    return Built(ctypes.CDLL(str(out)), out, time.perf_counter() - t0,
                 proc.stdout + proc.stderr)


def use(built: dict) -> None:
    """Make the port's wrappers launch this variant's libraries."""
    from repro_torch.kernels import build
    build._built.update(built)


def spills(log: str, kernel: str, R: int) -> int:
    key = None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \w*" + kernel +
                      r"ILi(\d+)ELi(\d+)E", ln)
        if m:
            key = int(m.group(1))
            continue
        sp = re.search(r"(\d+) bytes spill stores", ln)
        if sp and key == R:
            return int(sp.group(1))
        key = None
    return -1


def cuda_ms(fn, reps: int) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frames_for(trellis, spec, nframes, gen):
    import torch
    from repro_torch.channel.sim import awgn, bpsk
    from repro_torch.core.encoder import encode
    from repro_torch.core.framed import frame_llr
    bits = torch.randint(0, 2, (nframes * spec.f,), generator=gen,
                         device=gen.device)
    llr = awgn(bpsk(encode(bits, trellis)), 3.0, gen)
    return frame_llr(llr, spec).contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--json", type=Path,
                    default=OUT_DIR / "acs_variants.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import viterbi_fwd as vf
    from repro_torch.kernels import viterbi_unified as vu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    dirs = {v: make_variant(v, e) for v, e in VARIANTS.items()}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = {(v, s): pool.submit(nvcc, dirs[v] / s)
                for v in VARIANTS for s in SOURCES}
        libs = {v: {s: jobs[v, s].result() for s in SOURCES}
                for v in VARIANTS}
    print(f"[build] {len(jobs)} variant sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for wname, k, polys, bm_dtype in WORKLOADS:
        tr = make_trellis(k, polys)
        R = max(1, tr.num_states // 32)
        frames = frames_for(tr, spec, args.frames, gen)
        ukw = dict(trellis=tr, v1=spec.v1, f=spec.f, v2=spec.v2, f0=spec.f0,
                   v2s=spec.v2s, frames_per_tile=4, pack_survivors=True,
                   radix=4, bm_dtype=bm_dtype)
        fkw = dict(trellis=tr, frames_per_tile=4, pack_survivors=True,
                   radix=4, layout="lane", bm_dtype=bm_dtype)
        small = frames[:8]
        want_u = vu.unified_decode_frames_plain(small, **ukw)
        want_f = vf.forward_frames_plain(small, **fkw)
        ref = None
        for v in VARIANTS:
            use(libs[v])
            got = (vu.unified_decode_frames_cuda(frames, **ukw),
                   vf.forward_frames_cuda(frames, **fkw))
            if not (torch.equal(got[0][:8], want_u)
                    and all(torch.equal(a[:8], b)
                            for a, b in zip(got[1], want_f))):
                raise AssertionError(f"{v} {wname}: kernel != plain version")
            if ref is None:
                ref = got
            elif not (torch.equal(got[0], ref[0]) and all(
                    torch.equal(a, b) for a, b in zip(got[1], ref[1]))):
                raise AssertionError(f"{v} {wname}: outputs differ from the "
                                     f"first variant's")
        fns = {"viterbi_unified":
               lambda: vu.unified_decode_frames_cuda(frames, **ukw),
               "viterbi_fwd": lambda: vf.forward_frames_cuda(frames, **fkw)}
        for kernel in ("viterbi_unified", "viterbi_fwd"):
            times = {v: [] for v in VARIANTS}
            order = list(VARIANTS)
            for r in range(args.rounds):
                for v in (order if r % 2 == 0 else order[::-1]):
                    use(libs[v])
                    times[v].append(cuda_ms(fns[kernel], args.reps))
            for v in VARIANTS:
                src = ("viterbi_unified.cu" if kernel == "viterbi_unified"
                       else "viterbi_fwd.cu")
                lib = libs[v][src]
                attrs = getattr(lib.lib, f"{kernel}_func_attrs")
                out = (ctypes.c_int * 3)()
                attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
                if attrs(k, 2, out) != 0:
                    raise RuntimeError(f"{v}: no attributes")
                q = statistics.quantiles(times[v], n=4)
                row = {"workload": wname, "kernel": kernel, "variant": v,
                       "median_ms": statistics.median(times[v]),
                       "q1_ms": q[0], "q3_ms": q[2], "min_ms": min(times[v]),
                       "registers": out[0],
                       "spilled_bytes": spills(lib.log, kernel + "_kernel",
                                               R),
                       "ms": times[v]}
                results.append(row)
                print(f"[time] {wname} {kernel} {v}: median "
                      f"{row['median_ms']:.4f} ms (q1 {q[0]:.4f}, q3 "
                      f"{q[2]:.4f}, min {row['min_ms']:.4f}; "
                      f"{args.rounds} x {args.reps} launches) registers "
                      f"{out[0]} spilled {row['spilled_bytes']} B",
                      flush=True)
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(
        {"device": smi.stdout.strip(), "frames": args.frames,
         "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
