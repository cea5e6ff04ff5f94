#!/usr/bin/env python3
"""Drive the PyTorch port's receiver path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card,
`nvcc` and PyTorch built for CUDA. It imports the port (`src/repro_torch`)
and nothing of JAX. Phases, one line each; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — nvcc builds every kernel of the path from `kernels/csrc`;
             prints the seconds and the -Xptxas -v report.
3. parity  — each kernel's wrapper against its plain torch version on the
             card, exactly (torch.equal), over the knob grid and codes, a
             ragged frame count, a frame too long for shared memory, and
             the main path's own shape.
4. main    — make_decoder(backend="kernel") at full size: K=7, n = 2^22
             bits, Eb/N0 = 3 dB, rates 1/2 and 3/4. Launch counts are set
             to 0 just before and read just after; the bits must equal
             backend="reference" on the same LLRs, and the rate-1/2 BER
             must be below 1e-3.
5. time    — each kernel at the main path's shape with CUDA events, beside
             its plain version and its bound.

    python3 chip_smoke.py --profile

adds, after phase 5, a torch.profiler breakdown of one warm rate-1/2
make_decoder call: device time by kernel and the device's busy share.

The line before the last is a JSON `kernels` line; the last line is the
JSON `ok` line with the device.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_BITS = 1 << 22
EBN0_DB = 3.0
BER_LIMIT = 1e-3
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# ACS operations per state and stage: two candidate adds, compare, select,
# the max reduction's compare and the normalising subtract.
ACS_OPS = 6


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


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def phase_build():
    from repro_torch.kernels import viterbi_unified as vu
    built = vu.kernel_library()
    # ptxas -v: per instantiation (one per beta) a spill line, then "Used"
    report, beta = [], "?"
    for ln in built.log.splitlines():
        m = re.search(r"viterbi_unified_kernelILi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            beta = m.group(1)
        elif "spill" in ln:
            spill = re.findall(r"(\d+) bytes spill stores", ln)
        elif "Used" in ln and beta != "?":
            regs = re.search(r"Used (\d+) registers", ln)
            report.append(f"beta={beta}: {regs.group(1) if regs else '?'} "
                          f"regs, {spill[0] if spill else '?'} B spilled")
            beta = "?"
    log("build", f"{built.path.name} nvcc {built.seconds:.1f} s; "
        + "; ".join(report))


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


def phase_parity(gen):
    import torch
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.trellis import make_trellis
    from repro_torch.kernels import ops
    from repro_torch.kernels import viterbi_unified as vu

    codes = [(4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
             (7, (0o171, 0o133)), (9, (0o753, 0o561))]
    specs = [FrameSpec(f=64, v1=20, v2=21),                         # serial
             FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),          # boundary
             FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")]
    checked = 0
    for k, polys in codes:
        tr = make_trellis(k, polys)
        for spec in specs:
            frames = _frames(tr, spec, 12, gen, torch.float32)
            f0 = spec.f0 if spec.parallel_tb else spec.f
            v2s = spec.v2s if spec.parallel_tb else spec.v2
            for pack in (False, True):
                for radix in (2, 4):
                    for layout in ("lane", "sublane"):
                        for bm in ("float32", "bfloat16"):
                            kw = dict(trellis=tr, v1=spec.v1, f=spec.f,
                                      v2=spec.v2, f0=f0, v2s=v2s,
                                      start=spec.start, frames_per_tile=4,
                                      pack_survivors=pack, radix=radix,
                                      layout=layout, bm_dtype=bm)
                            got = vu.unified_decode_frames_cuda(frames, **kw)
                            want = vu.unified_decode_frames_plain(frames, **kw)
                            if not torch.equal(got, want):
                                raise AssertionError(f"kernel != plain: k={k} "
                                                     f"{spec} {kw}")
                            checked += 1
    # LLRs arriving in bf16/f16, a ragged frame count through ops' padding
    tr = make_trellis(7, (0o171, 0o133))
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    for dtype in (torch.bfloat16, torch.float16):
        frames = _frames(tr, spec, 8, gen, dtype)
        kw = dict(trellis=tr, v1=16, f=64, v2=20, f0=16, v2s=20,
                  frames_per_tile=8, pack_survivors=True, radix=4)
        if not torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                           vu.unified_decode_frames_plain(frames, **kw)):
            raise AssertionError(f"kernel != plain for {dtype} LLRs")
        checked += 1
    frames = _frames(tr, spec, 13, gen, torch.float32)
    got = ops.viterbi_decode_frames(frames, tr, spec, frames_per_tile=8,
                                    device="cuda")
    want = ops.viterbi_decode_frames(frames.cpu(), tr, spec,
                                     frames_per_tile=8, device="cpu")
    if not torch.equal(got.cpu(), want):
        raise AssertionError("ragged frame count: card != cpu")
    checked += 1
    # one frame too long for shared memory: survivors in device scratch
    long_spec = FrameSpec(f=4096, v1=45, v2=45)
    frames = _frames(tr, long_spec, 2, gen, torch.float32)
    kw = dict(trellis=tr, v1=45, f=4096, v2=45, f0=4096, v2s=45,
              frames_per_tile=1, pack_survivors=False, radix=2)
    if not torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                       vu.unified_decode_frames_plain(frames, **kw)):
        raise AssertionError("device-memory survivor scratch: kernel != plain")
    checked += 1
    log("parity", f"{checked} kernel calls equal to the plain version "
        f"(codes K=4 beta=3, K=5, K=7, K=9; pack x radix x layout x "
        f"bm_dtype; serial, boundary, fixed; bf16/f16 LLRs; ragged F; "
        f"device-memory survivors)")


def main_config(rate: str, backend: str):
    """The paper's configuration at rate 1/2. Rate 3/4 needs f, v1, v2 in
    multiples of the puncturing period 3, so it takes the repo's rate-3/4
    receiver frame (examples/sdr_pipeline.py)."""
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.pipeline import DecoderConfig
    spec = (FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45) if rate == "1/2"
            else FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45))
    return DecoderConfig(spec=spec, rate=rate, backend=backend)


def phase_main(gen):
    """Returns (launches on the main path, the rate-1/2 frames and
    received stream)."""
    import torch
    from repro_torch.channel.sim import ber, channel
    from repro_torch.core.framed import frame_llr
    from repro_torch.core.pipeline import make_decoder
    from repro_torch.core.puncture import depuncture
    from repro_torch.kernels import viterbi_unified as vu

    streams = {rate: channel(gen, N_BITS, EBN0_DB, rate)
               for rate in ("1/2", "3/4")}
    decoders = {rate: make_decoder(main_config(rate, "kernel"), "cuda")
                for rate in streams}
    torch.cuda.synchronize()
    vu.unified_decode_frames_cuda.launches = 0
    t0 = time.perf_counter()
    decoded = {rate: decoders[rate](rx, N_BITS)
               for rate, (_, rx) in streams.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vu.unified_decode_frames_cuda.launches
    if launches < 1:
        raise AssertionError("the main path never launched viterbi_unified")
    for rate, (bits, rx) in streams.items():
        ref = make_decoder(main_config(rate, "reference"), "cuda")(rx, N_BITS)
        if not torch.equal(decoded[rate], ref):
            raise AssertionError(f"rate {rate}: kernel != reference backend")
        b = ber(decoded[rate], bits)
        if not (decoded[rate].shape == (N_BITS,)
                and decoded[rate].dtype == torch.int32):
            raise AssertionError(f"rate {rate}: bad output "
                                 f"{decoded[rate].shape} {decoded[rate].dtype}")
        log("main", f"rate {rate}: n={N_BITS} Eb/N0={EBN0_DB} dB BER={b:.3e} "
            f"equal to the reference backend")
        if rate == "1/2" and not b < BER_LIMIT:
            raise AssertionError(f"rate 1/2 BER {b} >= {BER_LIMIT}")
    log("main", f"viterbi_unified launches={launches}; both rates decoded in "
        f"{wall * 1e3:.1f} ms (host clock, after synchronize)")
    rx = streams["1/2"][1]
    spec = main_config("1/2", "kernel").spec
    frames = frame_llr(depuncture(rx, "1/2", N_BITS), spec).contiguous()
    return launches, frames, rx


def phase_time(frames, rx_half, launches):
    import torch
    from repro_torch.core.pipeline import make_decoder
    from repro_torch.core.trellis import STD_K7
    from repro_torch.kernels import ops
    from repro_torch.kernels import viterbi_unified as vu

    F, L, beta = frames.shape
    S = STD_K7.num_states
    kw = dict(trellis=STD_K7, v1=20, f=256, v2=45, f0=32, v2s=45,
              frames_per_tile=ops.AUTO_FRAMES_PER_TILE, pack_survivors=True,
              radix=4)
    got = vu.unified_decode_frames_cuda(frames, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = vu.unified_decode_frames_plain(frames, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got - want).abs().max())
    if err:
        raise AssertionError("main-shape kernel != plain version")
    for _ in range(3):                                   # warm-up
        vu.unified_decode_frames_cuda(frames, **kw)
    ms = cuda_ms(lambda: vu.unified_decode_frames_cuda(frames, **kw), 20)
    sweep = {}
    for name, knobs in [(f"tile{ft}", dict(frames_per_tile=ft))
                        for ft in (1, 2, 4, 8, 16)] + [
            ("unpacked", dict(pack_survivors=False)),
            ("radix2", dict(radix=2)),
            ("bf16_bm", dict(bm_dtype="bfloat16")),
            ("serial_tb", dict(f0=256, v2s=45))]:
        kt = dict(kw, **knobs)
        vu.unified_decode_frames_cuda(frames, **kt)
        sweep[name] = round(cuda_ms(
            lambda: vu.unified_decode_frames_cuda(frames, **kt), 10), 4)
    # the whole receiver call (clip, depuncture, frame, kernel, stitch)
    rx = rx_half.reshape(-1)
    decode = make_decoder(main_config("1/2", "kernel"), "cuda")
    decode(rx, N_BITS)
    e2e_ms = cuda_ms(lambda: decode(rx, N_BITS), 5)
    nbytes = frames.numel() * frames.element_size() + F * 256 * 4
    nops = ACS_OPS * F * L * S
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = nops / PEAK_F32_OPS_S * 1e3
    bits_out = F * 256
    log("time", f"viterbi_unified F={F} L={L}: {ms * 1e3:.1f} us/launch "
        f"({bits_out / ms / 1e3:.1f} Mb/s); plain version {plain_ms:.1f} ms "
        f"(host clock, once); bound {max(bytes_ms, ops_ms) * 1e3:.1f} us "
        f"(bytes {bytes_ms * 1e3:.1f} us, ops {ops_ms * 1e3:.1f} us)")
    log("time", f"ms per launch by knob (default tile "
        f"{ops.AUTO_FRAMES_PER_TILE}, packed, radix 4, f32 bm, parallel "
        f"traceback): {sweep}")
    log("time", f"make_decoder rate 1/2 end to end: {e2e_ms:.3f} ms per "
        f"{N_BITS}-bit call ({N_BITS / e2e_ms / 1e3:.1f} Mb/s), kernel "
        f"{ms / e2e_ms:.0%} of it")
    return {"name": "viterbi_unified", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/viterbi_unified.cu",
            "replaces": "src/repro/kernels/viterbi_unified.py:199",
            "launches": launches, "max_abs_err": err, "parity": "equal",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None}


def phase_profile(rx_half):
    """Device time by kernel over one warm make_decoder call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.pipeline import make_decoder
    decode = make_decoder(main_config("1/2", "kernel"), "cuda")
    rx = rx_half.reshape(-1)
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
    log("profile", f"one call: host {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({busy / wall_us:.0%}); by kernel: "
        + "; ".join(f"{k[:60]} x{c} {us:.0f} us" for us, k, c in rows[:8]))


def main() -> int:
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
    phase_build()
    phase_parity(gen)
    launches, frames, rx = phase_main(gen)
    entry = phase_time(frames, rx, launches)
    if "--profile" in sys.argv[1:]:
        phase_profile(rx)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"JAX-side modules were imported: {bad[:5]}")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
