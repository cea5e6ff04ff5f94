"""B1's thread mapping (one thread a frame at 3 <= k <= 7, beta <= 3) on
the card: bit for bit against the plain version
(``unified_decode_frames_plain``) and against the warp mapping that the
wrappers' private ``_warp=True`` forces, over every code it takes, pack on
and off, f32/bf16/f16 LLRs, bf16 branch metrics, boundary, fixed and
serial starts, a ragged frame count, a block shrunk until its survivor
rings fit and a frame whose ring fits no block (which runs on the warp
mapping); its ring and register model against the built kernel; and the
receiver calls that reach it: the K=7 rate-1/2 call and
the punctured K=7 call at the k7_r34_batch shape (66,624 rows), which
equal their reference backends and count their launches on the mapping.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with
``pytest -m gpu tests/test_torch_gpu_thread_mapping.py``. Imports no JAX;
tests/test_torch_thread_mapping.py holds the mapping's model to the plain
version on the CPU.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.channel.sim import channel
from repro_torch.core.encoder import encode
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.obs import tracer as obs

pytestmark = pytest.mark.gpu

#: Every k the mapping takes at rates 1/2 and 1/3: K=3, K=4 rate 1/3, K=5,
#: K=6, the K=7 cells' code in both generator orders, K=7 rate 1/3, and
#: two codes with a polynomial short of a tap (four metrics a butterfly).
THREAD_CODES = [(3, (0o7, 0o5)), (4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
                (6, (0o65, 0o57)), (7, (0o171, 0o133)), (7, (0o133, 0o171)),
                (7, (0o171, 0o133, 0o165)), (5, (0o23, 0o16)),
                (7, (0o133, 0o070))]
SPECS = [FrameSpec(f=64, v1=20, v2=21),
         FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),
         FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed"),
         FrameSpec(f=60, v1=9, v2=13, f0=4, v2s=7),
         FrameSpec(f=60, v1=9, v2=13, f0=1, v2s=3),
         FrameSpec(f=60, v1=9, v2=13, f0=2, v2s=0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(code, spec, nframes, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    tr = make_trellis(*code)
    bits = torch.from_numpy(rng.integers(0, 2, nframes * spec.f))
    tx = 1.0 - 2.0 * encode(bits, tr).to(torch.float32)
    llr = tx + 0.8 * torch.from_numpy(
        rng.standard_normal(tuple(tx.shape)).astype(np.float32))
    return frame_llr(llr, spec).to(device=device, dtype=dtype).contiguous()


def _kw(code, spec, **knobs):
    parallel = spec.parallel_tb
    return dict(trellis=make_trellis(*code), v1=spec.v1, f=spec.f,
                v2=spec.v2, f0=spec.f0 if parallel else spec.f,
                v2s=spec.v2s if parallel else spec.v2, start=spec.start,
                **knobs)


def _thread(frames, mapping="thread", **kw):
    """B1 on ``frames`` forced onto the thread mapping whatever their
    count (``_thread``), asserting one launch on ``mapping``."""
    before = dict(vu.unified_decode_frames_cuda.mapping_launches)
    got = vu.unified_decode_frames_cuda(frames, _thread=True, **kw)
    torch.cuda.synchronize()
    after = vu.unified_decode_frames_cuda.mapping_launches
    want = dict.fromkeys(before, 0)
    want[mapping] = 1
    assert {m: after[m] - before[m] for m in after} == want
    assert vu.unified_decode_frames_cuda.last_mapping == mapping
    return got


@pytest.mark.parametrize("code", THREAD_CODES, ids=str)
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("bm", ["float32", "bfloat16"])
def test_thread_equals_plain_and_warp(cuda, code, spec, bm):
    """39 frames in blocks of 13 (a warp's ragged lanes), pack on and off:
    the plain version's bits, and the warp mapping's."""
    assert autotune.b1_mapping(make_trellis(*code)) == "thread"
    frames = _frames(code, spec, 39, 0, cuda)
    for pack in (False, True):
        kw = _kw(code, spec, frames_per_tile=13, pack_survivors=pack,
                 radix=4, bm_dtype=bm)
        want = vu.unified_decode_frames_plain(frames, **kw)
        warp = vu.unified_decode_frames_cuda(frames, _warp=True, **kw)
        assert torch.equal(warp, want)
        assert torch.equal(_thread(frames, **kw), want)


@pytest.mark.parametrize("code", THREAD_CODES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_thread_reads_half_inputs(cuda, code, dtype):
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    frames = _frames(code, spec, 64, 1, cuda, dtype)
    kw = _kw(code, spec, frames_per_tile=32, pack_survivors=True)
    want = vu.unified_decode_frames_plain(frames, **kw)
    assert torch.equal(_thread(frames, **kw), want)


@pytest.mark.parametrize("f", [4096, 32768])
def test_thread_long_serial_frame(cuda, f):
    """K=7 serial tracebacks: at f=4096 a ring of 4141 stages a frame,
    the tile of 8 shrunk to the 4 frames whose rings fit; at f=32768 one
    frame's ring (32,813 stages) fits no block, and B1 runs the code on
    the warp mapping and its device-memory scratch."""
    spec = FrameSpec(f=f, v1=45, v2=45)
    frames = _frames(THREAD_CODES[4], spec, 8, 2, cuda)
    kw = _kw(THREAD_CODES[4], spec, frames_per_tile=8)
    assert torch.equal(_thread(frames, "thread" if f == 4096 else "warp",
                               **kw),
                       vu.unified_decode_frames_plain(frames, **kw))


@pytest.mark.parametrize("code", THREAD_CODES, ids=str)
def test_ring_and_registers_equal_the_kernel(cuda, code):
    """The planner's ring slots, shared memory and registers are the
    built kernel's (viterbi_thread_slots, viterbi_unified_thread_smem_bytes,
    cudaFuncGetAttributes), and the thread kernel spills nothing."""
    tr = make_trellis(*code)
    lib = vu.kernel_library().lib
    for f0, v2s in ((32, 45), (256, 45), (4, 7)):
        Z = autotune.thread_ring_slots(f0, v2s)
        assert lib.viterbi_thread_slots(f0, v2s) == Z
        spec = FrameSpec(f=4 * f0, v1=20, v2=v2s, f0=f0, v2s=v2s)
        for fpb in (1, 13, 32, 256):
            assert lib.viterbi_unified_thread_smem_bytes(
                tr.k, tr.beta, f0, v2s, fpb) == \
                autotune.unified_smem_bytes(tr, spec, fpb)[0]
    out = (ctypes.c_int * 3)()
    assert lib.viterbi_unified_thread_attrs(tr.k, tr.beta, out) == 0
    assert autotune.kernel_registers(tr, device="cuda") == out[0]
    assert out[1] == 0, f"{out[1]} bytes of local memory"
    assert lib.viterbi_thread_code(tr.k, tr.beta) == 1
    assert lib.viterbi_thread_code(8, 2) == 0
    assert lib.viterbi_thread_code(7, autotune.THREAD_MAX_BETA + 1) == 0


def test_k7_receiver_call_takes_the_thread_mapping(cuda):
    """A K=7 kernel-backend call of 16,385 frames: one B1 launch, on the
    thread mapping, whose ``decode.kernel`` span says so; bits equal the
    reference backend's."""
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    n = 16384 * 256 + 17
    gen = torch.Generator(device=cuda).manual_seed(3)
    _, rx = channel(gen, n, 3.0)
    decode = make_decoder(DecoderConfig(spec=spec, backend="kernel"), cuda)
    decode(rx, n)
    before = dict(vu.unified_decode_frames_cuda.mapping_launches)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        got = decode(rx, n)
    finally:
        obs.set_tracer(prev)
    after = vu.unified_decode_frames_cuda.mapping_launches
    assert after["thread"] == before["thread"] + 1
    assert after["warp"] == before["warp"]
    (kern,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
    assert kern.attrs["mapping"] == "thread"
    want = make_decoder(DecoderConfig(spec=spec), cuda)(rx, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("frames", [64, 4096, 8448, 16384])
def test_mapping_follows_the_frame_count(cuda, frames):
    """Unforced, B1 takes the thread mapping where the frames fill the
    card (``autotune.thread_mapping``: 64 an SM), else the warp mapping;
    the bits equal the other mapping's either way, and a K=7 call's
    ``decode.kernel`` span names the mapping that ran."""
    code = THREAD_CODES[4]
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    x = _frames(code, spec, frames, 5, cuda)
    kw = _kw(code, spec, frames_per_tile=32, pack_survivors=True)
    want = autotune.b1_mapping(make_trellis(*code), frames=frames,
                               device=cuda)
    assert want == ("thread" if autotune.thread_mapping(
        make_trellis(*code), frames=frames, device=cuda) else "warp")
    before = dict(vu.unified_decode_frames_cuda.mapping_launches)
    got = vu.unified_decode_frames_cuda(x, **kw)
    after = vu.unified_decode_frames_cuda.mapping_launches
    assert after[want] == before[want] + 1
    assert vu.unified_decode_frames_cuda.last_mapping == want
    other = (vu.unified_decode_frames_cuda(x, _warp=True, **kw)
             if want == "thread" else
             vu.unified_decode_frames_cuda(x, _thread=True, **kw))
    assert torch.equal(got, other)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        ops.viterbi_decode_frames(x, make_trellis(*code), spec,
                                  device=cuda)
    finally:
        obs.set_tracer(prev)
    (kern,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
    assert kern.attrs["mapping"] == want


@pytest.mark.parametrize("tile", [64, "auto"], ids=str)
@pytest.mark.parametrize("polys", [(0o171, 0o133), (0o133, 0o171)], ids=str)
def test_punctured_k7_call_at_the_cell_equals_the_plain_chain(cuda, polys,
                                                              tile):
    """The k7_r34_batch call's shape (2^24 bits, 66,577 frames: 66,624 rows
    at tile 64, the planner's own tile else): the punctured kernel-backend
    call runs B1 once, on the thread mapping, over those rows, and decodes
    the reference backend's bits, in both generator orders."""
    n = 1 << 24
    spec = FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45)
    tr = make_trellis(7, polys)
    gen = torch.Generator(device=cuda).manual_seed(9)
    _, rx = channel(gen, n, 5.5, rate="3/4", trellis=tr)
    cfg = DecoderConfig(trellis=tr, spec=spec, rate="3/4", backend="kernel",
                        frames_per_tile=tile)
    decode = make_decoder(cfg, cuda)
    decode(rx, n)
    before = dict(vu.unified_decode_frames_cuda.mapping_launches)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        got = decode(rx, n)
    finally:
        obs.set_tracer(prev)
    torch.cuda.synchronize()
    after = vu.unified_decode_frames_cuda.mapping_launches
    assert after["thread"] == before["thread"] + 1
    (kern,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
    F = spec.num_frames(n)
    assert kern.attrs["mapping"] == "thread"
    assert kern.attrs["frames"] == ops.tile_rows(
        F, kern.attrs["frames_per_tile"])
    if tile == 64:
        assert kern.attrs["frames"] == 66624
    want = make_decoder(DecoderConfig(trellis=tr, spec=spec, rate="3/4"),
                        cuda)(rx, n)
    assert got.shape == (n,) and torch.equal(got, want)
