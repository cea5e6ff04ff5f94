"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu.py``. The
card's machine has no JAX, so this file imports none: parity with the JAX
package is held on the CPU (test_torch_kernels.py, test_torch_pipeline.py,
test_torch_split.py, test_torch_autotune.py) and each kernel is held here,
exactly (torch.equal), to its plain version.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.encoder import encode
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.trellis import STD_K7, make_trellis
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import traceback_frames as tbf
from repro_torch.kernels import viterbi_fwd as vf
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.kernels.tunedb import TuneDB

pytestmark = pytest.mark.gpu

#: K=3 (S=4: eight frames a warp), K=4 beta=3, K=5, K=6 (S=32: one
#: register a lane), K=7, K=9 and K=11 (S=1024: 32 registers a lane).
CODES = [(3, (0o7, 0o5)), (4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
         (6, (0o65, 0o57)), (7, (0o171, 0o133)), (9, (0o753, 0o561)),
         (11, (0o3345, 0o3613))]
K7 = CODES[4]
#: The large codes (the cluster mapping's one-block form: one block a
#: frame, path metrics in shared memory): K=12 (256 threads of 4
#: butterflies), K=13 (128 of 16), the Galileo (15, 1/4) code (512 of 16),
#: K=14 (256 of 16) and a K=12 rate-1/8 code (a 256-entry butterfly table
#: a stage).
LARGE_CODES = [(12, (0o4335, 0o5723)), (13, (0o10533, 0o17661)),
               (15, (0o46321, 0o51271, 0o63667, 0o70535)),
               (14, (0o21645, 0o35661)),
               (12, (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163,
                     0o7555))]
#: The wide mapping (every code past k = 15; a cluster of 2^(k-15) blocks
#: a frame at k = 16-19, else one block, k and beta at run time): k = 16,
#: 17, 18 at rate 1/2 and k = 16 at rate 1/3, codes of
#: tests/test_torch_large_codes.py, which holds their plain versions
#: against JAX.
WIDE_CODES = [(16, (0o135417, 0o163251)), (17, (0o247153, 0o365715)),
              (18, (0o523571, 0o634657)),
              (16, (0o135417, 0o163251, 0o117643))]
#: Rates below 1/8 at k <= 15 (the fast mappings with beta at run time:
#: the register mapping to k = 11, the one-block form's per-edge sums
#: past it): K=5 rate 1/12 (top taps only), K=7 rate 1/9 and 1/16, K=9
#: rate 1/10, K=11 rate 1/9 (one polynomial without its bottom tap: four
#: sums a butterfly), K=12, 13 and 15 at rate 1/9.
LOW_RATE_CODES = [
    (5, (0o21, 0o23, 0o25, 0o27, 0o31, 0o33, 0o35, 0o37, 0o20, 0o22, 0o24,
         0o26)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173)),
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
    llr = tx + 0.7 * torch.from_numpy(
        rng.standard_normal(tuple(tx.shape)).astype(np.float32))
    return frame_llr(llr, spec).to(device=device, dtype=dtype).contiguous()


def _kw(code, spec, **knobs):
    parallel = spec.parallel_tb
    return dict(trellis=make_trellis(*code), v1=spec.v1, f=spec.f,
                v2=spec.v2, f0=spec.f0 if parallel else spec.f,
                v2s=spec.v2s if parallel else spec.v2, start=spec.start,
                **knobs)


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("spec", [
    FrameSpec(f=64, v1=20, v2=21),
    FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),
    FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")])
@pytest.mark.parametrize("bm", ["float32", "bfloat16"])
def test_kernel_equals_plain(cuda, code, spec, bm):
    frames = _frames(code, spec, 12, 0, cuda)
    for pack in (False, True):
        for radix in (2, 4):
            kw = _kw(code, spec, frames_per_tile=4, pack_survivors=pack,
                     radix=radix, bm_dtype=bm)
            before = vu.unified_decode_frames_cuda.launches
            got = vu.unified_decode_frames(frames, **kw)
            torch.cuda.synchronize()
            assert vu.unified_decode_frames_cuda.launches == before + 1
            assert torch.equal(got, vu.unified_decode_frames_plain(frames,
                                                                   **kw))


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_reads_half_inputs(cuda, dtype, code):
    """Both kernels read bf16 and f16 LLRs as the plain version casts them."""
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    frames = _frames(code, spec, 8, 1, cuda, dtype)
    kw = _kw(code, spec, frames_per_tile=8, pack_survivors=True, radix=4)
    assert torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                       vu.unified_decode_frames_plain(frames, **kw))
    fkw = dict(trellis=kw["trellis"], frames_per_tile=8,
               pack_survivors=True, radix=4, layout="sublane")
    got, want = (vf.forward_frames_cuda(frames, **fkw),
                 vf.forward_frames_plain(frames, **fkw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("code,f,pack", [(K7, 4096, False),
                                         (CODES[6], 2048, True)])
def test_long_frame_uses_device_scratch(cuda, code, f, pack):
    """Unpacked K=7 survivors of an f=4096 frame (and packed K=11 ones of
    an f=2048 frame) exceed shared memory: the same kernel keeps them in
    device memory and still decodes exactly."""
    spec = FrameSpec(f=f, v1=45, v2=45)
    frames = _frames(code, spec, 2, 2, cuda)
    kw = _kw(code, spec, frames_per_tile=1, pack_survivors=pack)
    assert torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                       vu.unified_decode_frames_plain(frames, **kw))


@pytest.mark.parametrize("code", CODES)
def test_ragged_frame_count_through_ops(cuda, code):
    """13 frames through ops' padding, with a tile that does not divide
    them: the card's bits equal the CPU's, unified and split."""
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    frames = _frames(code, spec, 13, 7, cuda)
    tr = make_trellis(*code)
    for unified in (True, False):
        for layout in ("lane", "sublane"):
            kw = dict(unified=unified, layout=layout, frames_per_tile=4)
            got = ops.viterbi_decode_frames(frames, tr, spec, device="cuda",
                                            **kw)
            want = ops.viterbi_decode_frames(frames.cpu(), tr, spec,
                                             device="cpu", **kw)
            assert torch.equal(got.cpu(), want)


def test_main_path_goes_through_kernel(cuda):
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    n = 64 * 256 + 17
    rng = np.random.default_rng(3)
    stream = rng.standard_normal(2 * n).astype(np.float32)
    before = vu.unified_decode_frames_cuda.launches
    got = make_decoder(DecoderConfig(spec=spec, backend="kernel"))(stream, n)
    assert vu.unified_decode_frames_cuda.launches == before + 1
    want = make_decoder(DecoderConfig(spec=spec), "cuda")(stream, n)
    assert got.is_cuda and torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spec = FrameSpec(f=64, v1=16, v2=16)
    frames = _frames(K7, spec, 4, 4, cuda)
    kw = _kw(K7, spec, frames_per_tile=4)
    with pytest.raises(ValueError, match="dtype"):
        vu.unified_decode_frames_cuda(frames.to(torch.float64), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        vu.unified_decode_frames_cuda(
            frames.transpose(0, 1).contiguous().transpose(0, 1), **kw)


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("spec", [
    FrameSpec(f=64, v1=20, v2=21),
    FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),
    FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_split_kernels_equal_plain(cuda, code, spec, layout):
    """The forward kernel's sel and amax, and the traceback kernel's bits,
    equal their plain versions for every knob."""
    frames = _frames(code, spec, 12, 5, cuda)
    kw = _kw(code, spec)
    for pack in (False, True):
        for radix in (2, 4):
            for bm in ("float32", "bfloat16"):
                fkw = dict(trellis=kw["trellis"], frames_per_tile=4,
                           pack_survivors=pack, radix=radix, layout=layout,
                           bm_dtype=bm)
                before = vf.forward_frames_cuda.launches
                sel, amax = vf.forward_frames(frames, **fkw)
                assert vf.forward_frames_cuda.launches == before + 1
                psel, pamax = vf.forward_frames_plain(frames, **fkw)
                assert sel.dtype == psel.dtype and torch.equal(sel, psel)
                assert torch.equal(amax, pamax)
                tkw = dict(trellis=kw["trellis"], v1=spec.v1, f=spec.f,
                           f0=kw["f0"], v2s=kw["v2s"], start=spec.start,
                           packed=pack, layout=layout)
                before = tbf.traceback_frames_cuda.launches
                got = tbf.traceback_frames(sel, amax, **tkw)
                assert tbf.traceback_frames_cuda.launches == before + 1
                assert torch.equal(got, tbf.traceback_frames_plain(
                    psel, pamax, **tkw))


def test_split_path_goes_through_both_kernels(cuda):
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    n = 64 * 256 + 17
    rng = np.random.default_rng(6)
    stream = rng.standard_normal(2 * n).astype(np.float32)
    counters = (vf.forward_frames_cuda, tbf.traceback_frames_cuda,
                vu.unified_decode_frames_cuda)
    before = [c.launches for c in counters]
    got = make_decoder(DecoderConfig(spec=spec, backend="kernel_split"))(
        stream, n)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0]
    want = make_decoder(DecoderConfig(spec=spec), "cuda")(stream, n)
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.parametrize("code", CODES + LARGE_CODES + WIDE_CODES
                         + LOW_RATE_CODES)
def test_smem_models_equal_kernel_carve_up(cuda, code):
    """autotune's shared-memory models are the kernels' own numbers: the
    block of every mapping, and for 16 <= k <= 19 both the wide mapping's
    block off a cluster and a block of the cluster the card holds; for a
    large code the one-block form's threads, its block with the survivors
    on chip and in the scratch, and the blocks an SM holds of each (the
    card's occupancy query against the planner's model of threads, block
    slots, shared memory and the kernel's registers, and on an H100
    against ``H100_BLOCKS``, past beta = 8 its ``*_lowrate`` entries)."""
    tr = make_trellis(*code)
    ulib, flib = vu.kernel_library().lib, vf.kernel_library().lib
    C = autotune.wide_cluster(tr, "cuda") if autotune.wide_mapping(tr) else 1
    assert ulib.viterbi_cluster_size(tr.k) == autotune.cluster_size(tr)
    if autotune.smem_mapping(tr):
        T = autotune.large_threads(tr)
        assert ulib.viterbi_block_threads(tr.k, tr.beta) == T == \
            autotune.block_threads(tr, 1)
        limits = autotune.device_limits("cuda")
        h100 = "H100" in torch.cuda.get_device_name(0)
        for unified in (True, False):
            regs = autotune.kernel_registers(tr, unified=unified,
                                             device="cuda")
            core = autotune.split_smem_bytes(tr, FrameSpec(), 1)[0]
            got = autotune.block_capacity(tr, "cuda", unified=unified)
            assert got == autotune._resident_frames(core, T, 1, regs,
                                                    limits) >= 1
            if h100:
                assert got == autotune.H100_BLOCKS[
                    ("unified" if unified else "split")
                    + ("_lowrate" if autotune.low_rate(tr) else "")][tr.k]
        spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
        on, _ = autotune.unified_smem_bytes(tr, spec, 1, pack_survivors=True)
        assert on == ulib.viterbi_unified_block_smem_bytes(
            tr.k, spec.frame_len, 8, 1, 0, 0)
        if on <= limits.smem_per_block:
            assert autotune.block_capacity(tr, "cuda", smem=on) == \
                autotune._resident_frames(
                    on, T, 1, autotune.kernel_registers(tr, device="cuda"),
                    limits)
    else:
        assert ulib.viterbi_block_threads(tr.k, tr.beta) == (
            -1 if tr.k < 7 or tr.k > autotune.MAX_K
            else min(128, tr.num_states // 2))
    if C > 1:
        want = ulib.viterbi_cluster_smem_bytes(tr.k, C)
        assert want == autotune._wide_smem(tr, C)[0]
        assert ulib.viterbi_cluster_threads(tr.k, C) == \
            autotune.cluster_threads(tr, C) == \
            autotune.block_threads(tr, 1, C)
        for spec in (FrameSpec(f=64, v1=20, v2=21),
                     FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)):
            assert autotune.unified_smem_bytes(tr, spec, 1,
                                               cluster=C)[0] == want
            assert autotune.split_smem_bytes(tr, spec, 1,
                                             cluster=C)[0] == want
    specs = [FrameSpec(f=64, v1=20, v2=21),
             FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45),
             FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")]
    thread = autotune.thread_mapping(tr)
    for spec in specs:
        kw = _kw(code, spec)
        nsub = spec.f // kw["f0"]
        fixed = int(kw["start"] == "fixed")
        for fpb in autotune.candidate_tiles(tr):
            for pack in (False, True):
                got, _ = autotune.unified_smem_bytes(
                    tr, spec, fpb, pack_survivors=pack)
                # B1's thread mapping (3 <= k <= 7, beta <= 3): its ring
                # and LLR chunks, whatever pack says; else, and for a
                # launch of such a code on the warp mapping, the warp
                # mapping's carve-up
                warp = ulib.viterbi_unified_smem_bytes(
                    tr.k, tr.beta, spec.frame_len, nsub, int(pack), fixed,
                    fpb, 0)
                assert got == (ulib.viterbi_unified_thread_smem_bytes(
                    tr.k, tr.beta, kw["f0"], kw["v2s"], fpb) if thread
                    else warp)
                assert autotune.unified_smem_bytes(
                    tr, spec, fpb, pack_survivors=pack, warp=True)[0] == warp
            got, _ = autotune.split_smem_bytes(tr, spec, fpb)
            assert got == flib.viterbi_fwd_smem_bytes(tr.k, tr.beta, fpb)
        got, _ = autotune.unified_smem_bytes(tr, spec, 1, scratch=True)
        assert got == ulib.viterbi_unified_smem_bytes(
            tr.k, tr.beta, spec.frame_len, nsub, 1, fixed, 1, 1)
        assert ulib.viterbi_wide_code(tr.k, tr.beta) == \
            autotune.wide_mapping(tr)
        assert ulib.viterbi_wide_threads(tr.k) == autotune.wide_threads(tr)
        if autotune.wide_mapping(tr):           # the block off a cluster
            assert autotune.block_threads(tr, 1) == autotune.wide_threads(tr)


@pytest.mark.parametrize("unified", [True, False])
def test_register_model_is_the_kernels(cuda, unified):
    """The planner's registers are the built kernels' (cudaFuncGetAttributes),
    and on an H100 the count the CPU plans with is the K=7 beta=2
    instantiation's (for the large codes' one-block kernels, whose
    registers do not depend on beta <= 8, k=12's; no one-block kernel
    spills past what PERF.md records; for the wide one, which is one
    instantiation, every wide code's off a cluster; for the cluster kernel
    its k = 16-19 beta <= 8 instantiations', which run 16 butterflies a
    thread with the butterfly table); past beta = 8 the register form's
    K=7 beta=9 count and the one-block form's k=12 beta=9 count
    (``*_lowrate``)."""
    lib = (vu if unified else vf).kernel_library().lib
    attrs = (lib.viterbi_unified_func_attrs if unified
             else lib.viterbi_fwd_func_attrs)
    name = "unified" if unified else "split"
    h100 = "H100" in torch.cuda.get_device_name(0)
    for k in range(2, autotune.MAX_K + 1):
        for beta in range(2, 9):
            out = (ctypes.c_int * 3)()
            assert attrs(k, beta, out) == 0
            tr = make_trellis(k, tuple([(1 << k) - 1] * beta))
            if autotune.thread_mapping(tr, unified):   # B1's thread kernel
                thread = (ctypes.c_int * 3)()
                assert lib.viterbi_unified_thread_attrs(k, beta, thread) == 0
                assert autotune.kernel_registers(tr, device="cuda") == \
                    thread[0]
                assert autotune.kernel_registers(tr, device="cuda",
                                                 warp=True) == out[0]
                if h100 and (k, beta) == (7, 2):
                    assert autotune.H100_REGISTERS["unified_thread"] == \
                        thread[0]
            else:
                assert autotune.kernel_registers(tr, unified=unified,
                                                 device="cuda") == out[0]
            assert out[2] >= (autotune.large_threads(tr)
                              if autotune.smem_mapping(tr)
                              else autotune.BLOCK_THREADS)
            if h100 and (k, beta) == (7, 2):
                assert autotune.H100_REGISTERS[name] == out[0]
            if autotune.smem_mapping(tr):        # the one-block kernel's
                block = (ctypes.c_int * 3)()
                assert (lib.viterbi_unified_block_attrs if unified
                        else lib.viterbi_fwd_block_attrs)(k, beta, block) == 0
                assert list(block) == list(out)
                if h100 and k == autotune.SMEM_MIN_K:
                    assert autotune.H100_REGISTERS[name + "_block"] == \
                        out[0]
    for k, polys in LOW_RATE_CODES:
        tr = make_trellis(k, polys)
        out = (ctypes.c_int * 3)()
        assert attrs(k, tr.beta, out) == 0
        assert autotune.kernel_registers(tr, unified=unified,
                                         device="cuda") == out[0]
        assert out[2] >= autotune.block_threads(tr, 1)
        if autotune.smem_mapping(tr):
            block = (ctypes.c_int * 3)()
            assert (lib.viterbi_unified_block_attrs if unified
                    else lib.viterbi_fwd_block_attrs)(k, tr.beta, block) == 0
            assert list(block) == list(out)
        if h100 and (k, tr.beta) == (7, 9):
            assert autotune.H100_REGISTERS[name + "_lowrate"] == out[0]
        if h100 and (k, tr.beta) == (12, 9):
            assert autotune.H100_REGISTERS[name + "_block_lowrate"] == \
                out[0]
    cluster_attrs = (lib.viterbi_unified_cluster_attrs if unified
                     else lib.viterbi_fwd_cluster_attrs)
    for k, polys in WIDE_CODES:
        tr = make_trellis(k, polys)
        C = autotune.wide_cluster(tr, "cuda", unified=unified)
        out = (ctypes.c_int * 3)()
        assert attrs(k, tr.beta, out) == 0      # the wide kernel, no cluster
        assert autotune.kernel_registers(tr, unified=unified, device="cuda",
                                         cluster=1) == out[0]
        assert out[2] >= autotune.wide_threads(tr)
        if h100:
            assert autotune.H100_REGISTERS[name + "_wide"] == out[0]
        if C > 1:             # 16 <= k <= 19: the cluster kernel's
            out = (ctypes.c_int * 3)()
            assert cluster_attrs(k, tr.beta, C, out) == 0
            assert out[2] >= autotune.cluster_threads(tr, C)
            assert autotune.kernel_registers(tr, unified=unified,
                                             device="cuda") == out[0]
            if h100:
                assert autotune.H100_REGISTERS[name + "_cluster"] == out[0]
                assert autotune.cluster_capacity(
                    tr, C, "cuda", unified=unified) == \
                    autotune.H100_CLUSTERS[C]
    out = (ctypes.c_int * 3)()
    assert attrs(32, 2, out) != 0 and attrs(7, 33, out) != 0


def test_device_limits_query(cuda):
    """The queried limits are Hopper's, the ones the CPU plans with."""
    limits = autotune.device_limits("cuda")
    assert limits.smem_per_block >= 48 * 1024
    if "H100" in torch.cuda.get_device_name(0):
        assert limits == autotune.H100_LIMITS


def test_plan_decode_measures_into_a_temporary_db(cuda, tmp_path):
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    path = str(tmp_path / "tunedb.json")
    db = TuneDB(path)
    plan = autotune.plan_decode(STD_K7, spec, measure=True, tunedb=db,
                                measure_reps=2, measure_frames=64)
    assert db.stats()["measures"] >= 1
    rec = db.get(plan.fingerprint())
    assert rec["ms"] > 0 and rec["timer"] == "cuda_events"
    assert rec["interpret"] is False
    again = TuneDB(path)
    assert autotune.plan_decode(STD_K7, spec, measure=True, tunedb=again,
                                measure_reps=2, measure_frames=64) == plan
    assert again.stats()["measures"] == 0


# -- the stream and serve paths on the card ---------------------------------
def _stream_input(rate, n, seed):
    """A received stream (host numpy): (n, 2) at rate 1/2, the raw
    punctured symbols at rate 3/4."""
    from repro_torch.core.puncture import PATTERNS
    rng = np.random.default_rng(seed)
    coded = encode(torch.from_numpy(rng.integers(0, 2, n)), STD_K7).numpy()
    if rate != "1/2":
        pat = PATTERNS[rate]
        mask = np.tile(pat, (1, -(-n // pat.shape[1]))).T[:n]
        coded = coded.reshape(-1)[mask.reshape(-1).astype(bool)]
    out = 1.0 - 2.0 * coded + 0.6 * rng.standard_normal(coded.shape)
    return out.astype(np.float32)


_RATE_SPECS = {"1/2": FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45),
               "3/4": FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45)}


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
@pytest.mark.parametrize("chunk", [4, 37, 512])
def test_stream_decode_equals_make_decoder(cuda, rate, chunk):
    from repro_torch.core.stream import stream_decode
    cfg = DecoderConfig(spec=_RATE_SPECS[rate], rate=rate, backend="kernel")
    n = 600 * 256 + 77
    stream = _stream_input(rate, n, seed=chunk)
    want = make_decoder(cfg)(stream, n).cpu().numpy()
    before = vu.unified_decode_frames_cuda.launches
    got = stream_decode(cfg, stream, n, chunk_frames=chunk,
                        push_size=12345)
    assert vu.unified_decode_frames_cuda.launches > before
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_three_bucket_server_equals_stream_decode(cuda):
    """Rate 1/2 kernel, rate 3/4 kernel and rate 1/2 kernel_split buckets
    on one server: every session's bits equal stream_decode on the card."""
    import dataclasses
    from repro_torch.core.stream import stream_decode
    from repro_torch.serve import DecodeServer, PlanCache
    cfgs = [DecoderConfig(spec=_RATE_SPECS["1/2"], backend="kernel"),
            DecoderConfig(spec=_RATE_SPECS["3/4"], rate="3/4",
                          backend="kernel"),
            DecoderConfig(spec=_RATE_SPECS["1/2"], backend="kernel_split")]
    srv = DecodeServer(slots=8, cache=PlanCache())
    sessions = []
    for i in range(9):
        cfg = cfgs[i % 3]
        n = 40 * 256 + 100 * i
        stream = _stream_input(cfg.rate, n, seed=100 + i)
        sessions.append((srv.open_session(cfg, chunk_frames=8), cfg,
                         stream, n, []))
    assert len(srv.buckets()) == 3
    for start in range(0, 14000, 3000):
        for sid, cfg, stream, n, out in sessions:
            srv.push(sid, stream[start:start + 3000])
        srv.step()
        for sid, cfg, stream, n, out in sessions:
            out.append(srv.poll(sid))
    for sid, cfg, stream, n, out in sessions:
        out.append(srv.close_session(sid))
        got = np.concatenate(out)[:n]
        want = stream_decode(dataclasses.replace(cfg, backend="kernel"),
                             stream, n, chunk_frames=8)
        assert np.array_equal(got, want), (sid, cfg.backend, cfg.rate)
    tot = srv.metrics.totals()
    assert tot["launch_errors"] == tot["degraded"] == 0


def test_pinned_slots_reused_only_after_their_event(cuda):
    """A depth=2 stream whose chunks differ: every slot the pool hands out
    again has its last chunk's event completed, and the bits are exact —
    while a spinning kernel keeps the chunks in flight."""
    from repro_torch.core.stream import make_stream_decoder
    cfg = DecoderConfig(spec=_RATE_SPECS["1/2"], backend="kernel")
    n = 16 * 8 * 256
    stream = _stream_input("1/2", n, seed=7)
    stream[: n // 2] *= 0.25                    # chunks of unequal content
    dec = make_stream_decoder(cfg, chunk_frames=8, depth=2)
    pool = dec._staging
    handed = []
    acquire = pool.acquire

    def watched(n_in, n_out):
        slot = acquire(n_in, n_out)
        if any(s is slot for s in handed):
            assert slot.event.query(), "slot reused before its event"
        handed.append(slot)
        return slot

    pool.acquire = watched
    torch.cuda._sleep(int(2e8))
    got = np.concatenate([dec.push(stream[i:i + 3000])
                          for i in range(0, n, 3000)] + [dec.flush()])
    want = make_decoder(cfg)(stream, n).cpu().numpy()
    assert np.array_equal(got[:n], want)
    assert len({id(s) for s in handed}) <= 4     # depth + 1, + the flush


def _mesh_checks(mesh):
    """The sharded frame decoder (a frame count that does not divide the
    mesh), stream_decode at both rates and a DecodeServer over ``mesh``:
    bits equal the unsharded decode on the card, B1 launched once per
    shard of every chunk or server launch."""
    import dataclasses
    from repro_torch.core.pipeline import make_frame_decoder
    from repro_torch.core.stream import make_stream_decoder, stream_decode
    from repro_torch.distributed import make_sharded_frame_decoder
    from repro_torch.serve import DecodeServer, PlanCache
    cfg = DecoderConfig(spec=_RATE_SPECS["1/2"], backend="kernel")
    frames = _frames(K7, cfg.spec, 4 * mesh.size + 1, 3, mesh.home)
    before = vu.unified_decode_frames_cuda.launches
    got = make_sharded_frame_decoder(cfg, mesh)(frames)
    assert vu.unified_decode_frames_cuda.launches - before == mesh.size
    assert torch.equal(got, make_frame_decoder(cfg)(frames))
    for rate in ("1/2", "3/4"):
        rcfg = dataclasses.replace(cfg, spec=_RATE_SPECS[rate], rate=rate)
        n = 300 * 256 + 77
        stream = _stream_input(rate, n, seed=11)
        want = make_decoder(rcfg)(stream, n).cpu().numpy()
        dec = make_stream_decoder(rcfg, chunk_frames=37, mesh=mesh)
        before = vu.unified_decode_frames_cuda.launches
        got = np.concatenate([dec.push(stream[i:i + 12345])
                              for i in range(0, stream.shape[0], 12345)]
                             + [dec.flush()])[:n]
        assert (vu.unified_decode_frames_cuda.launches - before
                == dec.chunks * mesh.size)
        assert np.array_equal(got, want)
        assert np.array_equal(stream_decode(rcfg, stream, n, mesh=mesh),
                              want)
    srv = DecodeServer(slots=4, mesh=mesh, cache=PlanCache())
    sessions = []
    for i in range(4):
        n = 30 * 256 + 100 * i
        stream = _stream_input("1/2", n, seed=200 + i)
        sessions.append((srv.open_session(cfg, chunk_frames=8), stream, n))
    before = vu.unified_decode_frames_cuda.launches
    for sid, stream, n in sessions:
        srv.push(sid, stream)
    srv.drain()
    got = [np.concatenate([srv.poll(sid), srv.close_session(sid)])[:n]
           for sid, stream, n in sessions]
    assert (vu.unified_decode_frames_cuda.launches - before
            == srv.metrics.totals()["launches"] * mesh.size)
    for bits, (sid, stream, n) in zip(got, sessions):
        assert np.array_equal(bits, make_decoder(cfg)(stream, n).cpu().numpy())


def test_stream_and_server_mesh_not_ported(cuda):
    """(The name predates the frame-sharded decode.) A one-card mesh: the
    sharded frame decoder, the stream and the server equal the unsharded
    decode."""
    from repro_torch.distributed import FrameMesh
    mesh = FrameMesh(("cuda",))
    assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),)
    _mesh_checks(mesh)


def test_two_shard_mesh_on_one_card(cuda):
    from repro_torch.distributed import FrameMesh
    _mesh_checks(FrameMesh(("cuda:0", "cuda:0")))


def test_mesh_over_every_card(cuda):
    from repro_torch.distributed import frame_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    mesh = frame_mesh()
    assert mesh.size == torch.cuda.device_count()
    _mesh_checks(mesh)


def test_planning_a_bucket_loads_its_kernels(cuda):
    """open_session plans the bucket, and planning loads every kernel the
    bucket will launch (B3 and the traceback kernel for kernel_split), so
    a build failure surfaces there, outside the server's retried launch."""
    from repro_torch.kernels import build
    from repro_torch.serve import DecodeServer, PlanCache
    for src in ("viterbi_fwd.cu", "traceback_frames.cu"):
        build._built.pop(src, None)
    srv = DecodeServer(cache=PlanCache())
    srv.open_session(DecoderConfig(spec=_RATE_SPECS["1/2"],
                                   backend="kernel_split"), chunk_frames=8)
    assert {"viterbi_fwd.cu", "traceback_frames.cu"} <= set(build._built)


# -- codes 12 <= k <= 15 (the cluster mapping's one-block form) -------------
_SPECS = [FrameSpec(f=64, v1=20, v2=21),
          FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),
          FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")]


@pytest.mark.parametrize("code", LARGE_CODES)
@pytest.mark.parametrize("spec", _SPECS)
def test_large_code_kernels_equal_plain(cuda, code, spec):
    """B1, B3 and the traceback kernel at k = 12, 13, 14, 15 and k = 12
    beta = 8 against their plain versions: packed and not, radix 2 and 4,
    f32 and bf16 branch metrics, both layouts; serial, boundary and fixed
    starts."""
    frames = _frames(code, spec, 5, 8, cuda)
    kw = _kw(code, spec)
    tr = kw["trellis"]
    for pack in (False, True):
        for radix, bm in ((2, "float32"), (4, "bfloat16"), (4, "float32")):
            ukw = dict(kw, frames_per_tile=1, pack_survivors=pack,
                       radix=radix, bm_dtype=bm)
            before = vu.unified_decode_frames_cuda.launches
            got = vu.unified_decode_frames(frames, **ukw)
            assert vu.unified_decode_frames_cuda.launches == before + 1
            assert torch.equal(got, vu.unified_decode_frames_plain(frames,
                                                                   **ukw))
            for layout in ("lane", "sublane"):
                fkw = dict(trellis=tr, frames_per_tile=1,
                           pack_survivors=pack, radix=radix, layout=layout,
                           bm_dtype=bm)
                sel, amax = vf.forward_frames(frames, **fkw)
                psel, pamax = vf.forward_frames_plain(frames, **fkw)
                assert sel.dtype == psel.dtype and torch.equal(sel, psel)
                assert torch.equal(amax, pamax)
                tkw = dict(trellis=tr, v1=spec.v1, f=spec.f, f0=kw["f0"],
                           v2s=kw["v2s"], start=spec.start, packed=pack,
                           layout=layout)
                assert torch.equal(tbf.traceback_frames(sel, amax, **tkw),
                                   tbf.traceback_frames_plain(psel, pamax,
                                                              **tkw))


@pytest.mark.parametrize("code,f,pack", [(LARGE_CODES[0], 256, False),
                                         (LARGE_CODES[1], 512, True),
                                         (LARGE_CODES[2], 64, True)])
def test_large_code_survivor_scratch(cuda, code, f, pack):
    """Survivors that do not fit beside the path metrics (unpacked K=12,
    packed K=13 at f=512, every K=15 frame) go to the device-memory
    scratch; the planner counts that mode and the bits stay exact."""
    spec = FrameSpec(f=f, v1=30, v2=30, f0=f // 4, v2s=30)
    frames = _frames(code, spec, 3, 9, cuda)
    kw = _kw(code, spec, frames_per_tile=1, pack_survivors=pack, radix=4)
    tr = kw["trellis"]
    lib = vu.kernel_library().lib
    on_chip = lib.viterbi_unified_smem_bytes(tr.k, tr.beta, spec.frame_len,
                                             4, int(pack), 0, 1, 0)
    assert on_chip > autotune.device_limits("cuda").smem_per_block
    plan = autotune.plan_tiles(tr, spec, pack_survivors=pack, device="cuda")
    assert plan.fits and dict(plan.breakdown)["sel_survivors"] == 0
    assert torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                       vu.unified_decode_frames_plain(frames, **kw))


@pytest.mark.parametrize("code", LARGE_CODES)
def test_large_code_survivors_on_chip_and_in_scratch(cuda, monkeypatch,
                                                     code):
    """B1's one-block kernel with its survivors and starts on chip where
    the planner keeps them there (packed, a short frame) and in the
    device-memory scratch (forced), on the planner's grid and on 2 blocks
    that take the 7 frames in turn: bits equal the plain version's, packed
    and not, boundary and fixed starts."""
    tr = make_trellis(*code)
    specs = [FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21),
             FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed")]
    if tr.k <= 14:             # packed survivors fit beside the metrics
        assert autotune.block_survivors_on_chip(
            tr, specs[0], pack_survivors=True, frames=7, device="cuda")
    for grid in (None, 2):
        if grid is not None:
            monkeypatch.setattr(vu, "block_grid", lambda *a, **k: grid)
        for spec in specs:
            frames = _frames(code, spec, 7, 50, cuda)
            for pack in (False, True):
                kw = _kw(code, spec, frames_per_tile=1, pack_survivors=pack,
                         radix=4, bm_dtype="bfloat16" if pack else "float32")
                want = vu.unified_decode_frames_plain(frames, **kw)
                assert torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                                   want), (grid, spec, pack)
                with monkeypatch.context() as m:
                    m.setattr(vu, "block_survivors_on_chip",
                              lambda *a, **k: False)
                    assert torch.equal(vu.unified_decode_frames_cuda(
                        frames, **kw), want), (grid, spec, pack, "scratch")


def test_codes_past_the_limits_are_refused(cuda):
    """The codes past the fast mappings' limit (k > 15), which the wrappers
    once refused, run the wide mapping: each kernel equals its plain
    version (the unified bits, the forward sel and amax in both layouts,
    the traceback on them) over pack x radix x bm_dtype and the serial,
    boundary and fixed starts, and each launch is counted."""
    specs = [FrameSpec(f=32, v1=10, v2=11),
             FrameSpec(f=32, v1=10, v2=11, f0=8, v2s=11),
             FrameSpec(f=48, v1=6, v2=12, f0=12, v2s=10, start="fixed")]
    for code in WIDE_CODES:
        tr = make_trellis(*code)
        assert autotune.wide_mapping(tr)
        for si, spec in enumerate(specs):
            frames = _frames(code, spec, 3, 20 + si, cuda)
            for pack in (False, True):
                for radix in (2, 4):
                    for bm in ("float32", "bfloat16"):
                        kw = _kw(code, spec, frames_per_tile=1,
                                 pack_survivors=pack, radix=radix,
                                 bm_dtype=bm)
                        before = vu.unified_decode_frames_cuda.launches
                        got = vu.unified_decode_frames(frames, **kw)
                        torch.cuda.synchronize()
                        assert vu.unified_decode_frames_cuda.launches == \
                            before + 1
                        assert torch.equal(got, vu.unified_decode_frames_plain(
                            frames, **kw)), (code, spec, pack, radix, bm)
                        for layout in ("lane", "sublane"):
                            fkw = dict(trellis=tr, frames_per_tile=1,
                                       pack_survivors=pack, radix=radix,
                                       layout=layout, bm_dtype=bm)
                            before = vf.forward_frames_cuda.launches
                            sel, amax = vf.forward_frames(frames, **fkw)
                            assert vf.forward_frames_cuda.launches == \
                                before + 1
                            psel, pamax = vf.forward_frames_plain(frames,
                                                                  **fkw)
                            assert sel.dtype == psel.dtype
                            assert torch.equal(sel, psel), (code, fkw)
                            assert torch.equal(amax, pamax), (code, fkw)
                            tkw = dict(trellis=tr, v1=spec.v1, f=spec.f,
                                       f0=kw["f0"], v2s=kw["v2s"],
                                       start=spec.start, packed=pack,
                                       layout=layout)
                            before = tbf.traceback_frames_cuda.launches
                            got = tbf.traceback_frames(sel, amax, **tkw)
                            assert tbf.traceback_frames_cuda.launches == \
                                before + 1
                            assert torch.equal(got, tbf.traceback_frames_plain(
                                psel, pamax, **tkw)), (code, tkw)


@pytest.mark.parametrize("code", LOW_RATE_CODES,
                         ids=lambda c: f"k{c[0]}b{len(c[1])}")
@pytest.mark.parametrize("spec", _SPECS)
def test_low_rate_kernels_equal_plain(cuda, monkeypatch, code, spec):
    """B1, B3 and the traceback kernel at rates below 1/8 (the register
    mapping with beta at run time to k = 11, the one-block form's per-edge
    sums at k = 12-15) against their plain versions: packed and not,
    radix 2 and 4, f32 and bf16 branch metrics, both layouts; serial,
    boundary and fixed starts; each launch counted. B1 also with its
    survivors in the device-memory scratch (forced)."""
    tr = make_trellis(*code)
    assert autotune.low_rate(tr) and not autotune.wide_mapping(tr)
    frames = _frames(code, spec, 8, 61, cuda)
    kw = _kw(code, spec)
    for pack in (False, True):
        for radix in (2, 4):
            for bm in ("float32", "bfloat16"):
                ukw = dict(kw, frames_per_tile=4, pack_survivors=pack,
                           radix=radix, bm_dtype=bm)
                before = vu.unified_decode_frames_cuda.launches
                got = vu.unified_decode_frames(frames, **ukw)
                torch.cuda.synchronize()
                assert vu.unified_decode_frames_cuda.launches == before + 1
                want = vu.unified_decode_frames_plain(frames, **ukw)
                assert torch.equal(got, want), (code, spec, pack, radix, bm)
                with monkeypatch.context() as m:
                    for name in ("tile_survivors_on_chip",
                                 "block_survivors_on_chip"):
                        m.setattr(vu, name, lambda *a, **k: False)
                    assert torch.equal(vu.unified_decode_frames_cuda(
                        frames, **ukw), want), (code, spec, pack, "scratch")
                for layout in ("lane", "sublane"):
                    fkw = dict(trellis=tr, frames_per_tile=4,
                               pack_survivors=pack, radix=radix,
                               layout=layout, bm_dtype=bm)
                    before = vf.forward_frames_cuda.launches
                    sel, amax = vf.forward_frames(frames, **fkw)
                    assert vf.forward_frames_cuda.launches == before + 1
                    psel, pamax = vf.forward_frames_plain(frames, **fkw)
                    assert sel.dtype == psel.dtype
                    assert torch.equal(sel, psel), (code, fkw)
                    assert torch.equal(amax, pamax), (code, fkw)
                    tkw = dict(trellis=tr, v1=spec.v1, f=spec.f, f0=kw["f0"],
                               v2s=kw["v2s"], start=spec.start, packed=pack,
                               layout=layout)
                    assert torch.equal(tbf.traceback_frames(sel, amax, **tkw),
                                       tbf.traceback_frames_plain(
                                           psel, pamax, **tkw))


@pytest.mark.parametrize("code", LOW_RATE_CODES,
                         ids=lambda c: f"k{c[0]}b{len(c[1])}")
def test_wide_mapping_equals_low_rate_forms(cuda, monkeypatch, code):
    """The wide mapping forced (``_wide``), the one-block form's per-edge
    sums forced below k = 12 (``_block``) and a forced cluster of 2 blocks
    (its per-edge sums, ``_cluster``) equal the planner's run-time-beta
    form, bits, sel and amax, over pack x radix x bm_dtype and both
    layouts, on the planner's grid and on 3 blocks that take the frames in
    turn."""
    tr = make_trellis(*code)
    spec = FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21)
    frames = _frames(code, spec, 8, 33, cuda)
    forced = [dict(_wide=True), dict(_cluster=2)] + (
        [dict(_block=True)] if 7 <= tr.k < 12 else [])
    for grid in (None, 3):
        if grid is not None:
            for mod in (vu, vf):
                monkeypatch.setattr(mod, "wide_grid", lambda *a, **k: grid)
                monkeypatch.setattr(mod, "block_grid", lambda *a, **k: grid)
        for pack in (False, True):
            for radix in (2, 4):
                for bm in ("float32", "bfloat16"):
                    kw = _kw(code, spec, frames_per_tile=4,
                             pack_survivors=pack, radix=radix, bm_dtype=bm)
                    want = vu.unified_decode_frames_cuda(frames, **kw)
                    for force in forced:
                        assert torch.equal(vu.unified_decode_frames_cuda(
                            frames, **force, **kw), want), (force, kw)
                    for layout in ("lane", "sublane"):
                        fkw = dict(trellis=tr, frames_per_tile=4,
                                   pack_survivors=pack, radix=radix,
                                   layout=layout, bm_dtype=bm)
                        want = vf.forward_frames_cuda(frames, **fkw)
                        for force in forced:
                            got = vf.forward_frames_cuda(frames, **force,
                                                         **fkw)
                            assert all(torch.equal(g, w)
                                       for g, w in zip(got, want)), \
                                (force, fkw)


@pytest.mark.parametrize("code", [K7, LARGE_CODES[1], CODES[0],
                                  (7, (0o171, 0o132, 0o065))])
def test_wide_mapping_equals_fast_mappings(cuda, monkeypatch, code):
    """The wide mapping, forced through the launch's private flags, equals
    the register mapping (K=7, K=3) and the large codes' one-block form
    (K=13) on their codes: bits, sel and amax, over pack x radix x
    bm_dtype and both layouts, on the planner's grid and on a grid of 7
    blocks (clusters) that each take several frames in turn (the scratch
    reused). Off a cluster (``_wide``) and on clusters of 2, 4 and 8 blocks
    (``_cluster``; K=3's 4 states split over 2 at most), whose exchange
    through distributed shared memory and whose small-code survivor words
    (fewer than 32 butterflies a block) these codes reach; and the
    one-block form forced (``_block``) on the K=7 codes. The last code
    lacks a bottom and a top tap, so the cluster builds its four-metric
    butterfly table, not the one-metric table of the others."""
    tr = make_trellis(*code)
    spec = FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21)
    frames = _frames(code, spec, 40, 31, cuda)
    assert 1 <= autotune.wide_grid(tr, 40, cuda) <= 40
    forced = [dict(_wide=True)] + [
        dict(_cluster=C) for C in (2, 4, 8) if tr.num_states >= 2 * C] + (
        [dict(_block=True)] if tr.k == 7 else [])
    for grid in (None, 7):
        if grid is not None:
            for mod in (vu, vf):
                monkeypatch.setattr(mod, "wide_grid",
                                    lambda *a, **k: grid)
                monkeypatch.setattr(mod, "block_grid",
                                    lambda *a, **k: grid)
        for pack in (False, True):
            for radix in (2, 4):
                for bm in ("float32", "bfloat16"):
                    kw = _kw(code, spec, frames_per_tile=1,
                             pack_survivors=pack, radix=radix, bm_dtype=bm)
                    want = vu.unified_decode_frames_cuda(frames, **kw)
                    for force in forced:
                        assert torch.equal(vu.unified_decode_frames_cuda(
                            frames, **force, **kw), want), (force, kw)
                    for layout in ("lane", "sublane"):
                        fkw = dict(trellis=tr, frames_per_tile=1,
                                   pack_survivors=pack, radix=radix,
                                   layout=layout, bm_dtype=bm)
                        want = vf.forward_frames_cuda(frames, **fkw)
                        for force in forced:
                            got = vf.forward_frames_cuda(frames, **force,
                                                         **fkw)
                            assert all(torch.equal(g, w)
                                       for g, w in zip(got, want)), \
                                (force, fkw)


def test_cluster_mapping_at_k16(cuda, monkeypatch):
    """K=16 (the planner's cluster of 2) equals the plain versions, the
    wide mapping off a cluster (``_cluster=1``: path metrics in device
    memory) and the forced clusters of 4 and 8 blocks, over pack x radix
    x bm_dtype and both layouts, on the planner's clusters and on 3 that
    each take several frames in turn."""
    code = WIDE_CODES[0]
    tr = make_trellis(*code)
    assert autotune.wide_cluster(tr, "cuda") == 2
    spec = FrameSpec(f=32, v1=10, v2=11, f0=8, v2s=11)
    frames = _frames(code, spec, 7, 41, cuda)
    for grid in (None, 3):
        if grid is not None:
            for mod in (vu, vf):
                monkeypatch.setattr(mod, "wide_grid",
                                    lambda *a, **k: grid)
        for pack in (False, True):
            for radix in (2, 4):
                for bm in ("float32", "bfloat16"):
                    kw = _kw(code, spec, frames_per_tile=1,
                             pack_survivors=pack, radix=radix, bm_dtype=bm)
                    want = vu.unified_decode_frames_plain(frames, **kw)
                    for force in (None, 1, 4, 8):
                        assert torch.equal(vu.unified_decode_frames_cuda(
                            frames, _cluster=force, **kw), want), (force, kw)
                    for layout in ("lane", "sublane"):
                        fkw = dict(trellis=tr, frames_per_tile=1,
                                   pack_survivors=pack, radix=radix,
                                   layout=layout, bm_dtype=bm)
                        want = vf.forward_frames_plain(frames, **fkw)
                        for force in (None, 1, 4, 8):
                            got = vf.forward_frames_cuda(
                                frames, _cluster=force, **fkw)
                            assert all(torch.equal(g, w)
                                       for g, w in zip(got, want)), \
                                (force, fkw)


def test_cluster_the_card_cannot_hold_raises(cuda, monkeypatch):
    """A cluster of 32 blocks (past the H100's 16) is refused: by the
    planner, whose occupancy query the kernel library refuses, and, past
    the planner, by the launch function before any launch; the wrappers
    raise and fall back to nothing. The card decodes on after it."""
    code = WIDE_CODES[0]
    tr = make_trellis(*code)
    spec = FrameSpec(f=32, v1=10, v2=11, f0=8, v2s=11)
    frames = _frames(code, spec, 3, 43, cuda)
    kw = _kw(code, spec, frames_per_tile=1, pack_survivors=True)
    fkw = dict(trellis=tr, frames_per_tile=1, pack_survivors=True)
    assert vu.kernel_library().lib.viterbi_cluster_threads(tr.k, 32) == -1
    with pytest.raises(RuntimeError, match="refuses a cluster of 32"):
        autotune.wide_grid(tr, 3, cuda, cluster=32)
    with pytest.raises(RuntimeError):
        vu.unified_decode_frames_cuda(frames, _cluster=32, **kw)
    with pytest.raises(RuntimeError):
        vf.forward_frames_cuda(frames, _cluster=32, **fkw)
    before = (vu.unified_decode_frames_cuda.launches,
              vf.forward_frames_cuda.launches)
    for mod in (vu, vf):
        monkeypatch.setattr(mod, "wide_grid", lambda *a, **k: 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        vu.unified_decode_frames_cuda(frames, _cluster=32, **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        vf.forward_frames_cuda(frames, _cluster=32, **fkw)
    assert (vu.unified_decode_frames_cuda.launches,
            vf.forward_frames_cuda.launches) == before
    torch.cuda.synchronize()
    assert torch.equal(vu.unified_decode_frames_cuda(frames, **kw),
                       vu.unified_decode_frames_plain(frames, **kw))


def test_path_metric_scratch_only_off_a_cluster(cuda, monkeypatch):
    """The wrappers allocate the device-memory path metrics (grid, 2, S)
    only where the planner keeps a k > 15 code off a cluster."""
    code = WIDE_CODES[0]
    tr = make_trellis(*code)
    S = tr.num_states
    spec = FrameSpec(f=32, v1=10, v2=11, f0=8, v2s=11)
    frames = _frames(code, spec, 3, 47, cuda)
    kw = _kw(code, spec, frames_per_tile=1, pack_survivors=True)
    seen = []
    empty = torch.empty

    def recording_empty(*shape, **k):
        out = empty(*shape, **k)
        if out.dtype == torch.float32 and out.ndim == 3 and \
                tuple(out.shape[1:]) == (2, S):
            seen.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    for force, want in ((None, 0), (2, 0), (1, 1)):
        seen.clear()
        vu.unified_decode_frames_cuda(frames, _cluster=force, **kw)
        vf.forward_frames_cuda(frames, trellis=tr, frames_per_tile=1,
                               pack_survivors=True, _cluster=force)
        assert len(seen) == 2 * want, (force, seen)


def test_large_code_through_every_entry(cuda):
    """A K=13 and a K=16 rate-1/2 config through make_decoder (both kernel
    backends), stream_decode and a DecodeServer on the card: bits equal
    the plain decode."""
    for code in (LARGE_CODES[1], WIDE_CODES[0]):
        _code_through_every_entry(code)


def _code_through_every_entry(code):
    import dataclasses
    from repro_torch.core.stream import stream_decode
    from repro_torch.serve import DecodeServer, PlanCache
    tr = make_trellis(*code)
    spec = FrameSpec(f=128, v1=40, v2=60, f0=32, v2s=60)
    cfg = DecoderConfig(trellis=tr, spec=spec, backend="kernel")
    n = 20 * 128 + 33
    rng = np.random.default_rng(13)
    coded = encode(torch.from_numpy(rng.integers(0, 2, n)), tr).numpy()
    stream = (1.0 - 2.0 * coded + 0.5 * rng.standard_normal(coded.shape)
              ).astype(np.float32)
    want = make_decoder(cfg, "cpu")(stream, n).numpy()
    for backend, kernel in (("kernel", vu.unified_decode_frames_cuda),
                            ("kernel_split", tbf.traceback_frames_cuda)):
        bcfg = dataclasses.replace(cfg, backend=backend)
        before = kernel.launches
        got = make_decoder(bcfg)(stream, n)
        assert kernel.launches == before + 1
        assert np.array_equal(got.cpu().numpy(), want)
    before = vu.unified_decode_frames_cuda.launches
    got = stream_decode(cfg, stream, n, chunk_frames=8, push_size=1000)
    assert vu.unified_decode_frames_cuda.launches > before
    assert np.array_equal(got, want)
    srv = DecodeServer(slots=2, cache=PlanCache())
    sid = srv.open_session(cfg, chunk_frames=8)
    parts = []
    for i in range(0, n, 700):
        srv.push(sid, stream[i:i + 700])
        srv.step()
        parts.append(srv.poll(sid))
    parts.append(srv.close_session(sid))
    assert np.array_equal(np.concatenate(parts)[:n], want)


# -- the split traceback kernel's two modes ---------------------------------
@pytest.mark.parametrize("code", [CODES[2], K7, CODES[5], CODES[6],
                                  LARGE_CODES[0]])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
def test_traceback_modes_equal_plain(cuda, monkeypatch, code, layout, pack):
    """The staged and the direct chase equal the plain chase, whichever
    the rule would pick, for serial, boundary and fixed geometries, frame
    groups of 1 to 16 and a sublane stream sliced to fewer frames than it
    holds (read at its stride); the rule picks staged for rows of at most
    128 bytes whose smallest group fits (K=7 lane, K=11 packed lane) and
    direct otherwise (K=11 unpacked, K=12). The groups come from the
    plan's own inputs: a staged block takes at most MAX_GROUP frames, a
    direct block the fewest that cover the SMs it is given."""
    tr = make_trellis(*code)
    real_plan = tbf.chase_plan
    for spec in _SPECS:
        frames = _frames(code, spec, 37, 10, cuda)
        kw = _kw(code, spec)
        sel, amax = vf.forward_frames(frames, trellis=tr, frames_per_tile=1,
                                      pack_survivors=pack, layout=layout)
        F = 33
        sel = sel[..., :F] if layout == "sublane" else sel[:F]
        amax = amax[:F]
        tkw = dict(trellis=tr, v1=spec.v1, f=spec.f, f0=kw["f0"],
                   v2s=kw["v2s"], start=spec.start, packed=pack,
                   layout=layout)
        want = tbf.traceback_frames_plain(sel, amax, **tkw)
        row = 4 * (-(-tr.num_states // 32)) if pack else tr.num_states
        pkw = dict(L=spec.frame_len, f=spec.f, f0=kw["f0"], v2s=kw["v2s"],
                   F=F, packed=pack, layout=layout)
        plan = tbf.chase_plan(tr, **pkw)
        assert plan.smem_bytes == tbf.kernel_library().lib.\
            traceback_frames_smem_bytes(tr.k, spec.f, kw["v2s"],
                                        spec.frame_len, int(pack),
                                        int(layout == "sublane"),
                                        plan.frames, int(plan.staged))
        least = tbf.SUBLANE_MIN_GROUP if layout == "sublane" else 1
        assert plan.staged == (row <= tbf.STAGE_ROW_BYTES and tbf._smem_bytes(
            tr.k, spec.f, kw["v2s"], spec.frame_len, pack,
            layout == "sublane", least, True) <= tbf.STAGE_BYTES)
        before = tbf.traceback_frames_cuda.launches
        assert torch.equal(tbf.traceback_frames(sel, amax, **tkw), want)
        assert tbf.traceback_frames_cuda.launches == before + 1
        limit = autotune.device_limits("cuda").smem_per_block
        for chase in ("staged", "direct"):
            for group in (1, 3, 16):
                sms = -(-F // group)
                monkeypatch.setattr(tbf, "MAX_GROUP", group)
                monkeypatch.setattr(tbf, "chase_plan",
                                    lambda t, **a: real_plan(
                                        t, **dict(a, sms=sms,
                                                  blocks_per_sm=1)))
                try:
                    tbf.chase_plan(tr, chase=chase, smem_limit=limit, **pkw)
                except ValueError:        # a block this large cannot run
                    with pytest.raises(ValueError, match="shared memory"):
                        tbf.traceback_frames_cuda(sel, amax, chase=chase,
                                                  **tkw)
                    continue
                got = tbf.traceback_frames_cuda(sel, amax, chase=chase,
                                                **tkw)
                assert torch.equal(got, want), (chase, group, spec)
        monkeypatch.undo()


def test_traceback_modes_at_the_main_shape(cuda):
    """Lane packed at K=7 and K=11 (staged by the rule) and unpacked at
    K=11 (direct; a staged K=11 unpacked frame does not fit a block), at
    the main path's frame: each mode equals the plain chase."""
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    for code, pack, staged, modes in (
            (K7, True, True, ("auto", "staged", "direct")),
            (CODES[6], True, True, ("auto", "staged", "direct")),
            (CODES[6], False, False, ("auto", "direct"))):
        tr = make_trellis(*code)
        frames = _frames(code, spec, 2048 if code == K7 else 64, 11, cuda)
        sel, amax = vf.forward_frames(frames, trellis=tr, frames_per_tile=1,
                                      pack_survivors=pack)
        tkw = dict(trellis=tr, v1=20, f=256, f0=32, v2s=45, packed=pack)
        assert tbf.chase_plan(tr, L=spec.frame_len, f=256, f0=32, v2s=45,
                              F=frames.shape[0],
                              packed=pack).staged == staged
        want = tbf.traceback_frames_plain(sel, amax, **tkw)
        for chase in modes:
            assert torch.equal(tbf.traceback_frames_cuda(
                sel, amax, chase=chase, **tkw), want)


# -- the block-parallel decode (ops.py: reframe_blocks / merge_blocks) -------
@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_blocked_decode_on_the_card(cuda, unified, layout):
    """block_frames > 1 on the card equals the blocked plain decode on the
    CPU; with overlap >= full_overlap it equals the unblocked decode."""
    from repro_torch.kernels import block
    spec = FrameSpec(f=2048, v1=20, v2=45, f0=32, v2s=45)
    frames = _frames(K7, spec, 3, 12, cuda)
    tr = make_trellis(*K7)
    kw = dict(unified=unified, layout=layout)
    for bf, ov in ((8, 45), (16, 64)):
        got = ops.viterbi_decode_frames(frames, tr, spec, device="cuda",
                                        block_frames=bf, overlap=ov, **kw)
        want = ops.viterbi_decode_frames(frames.cpu(), tr, spec,
                                         device="cpu", block_frames=bf,
                                         overlap=ov, **kw)
        assert torch.equal(got.cpu(), want)
    full = block.full_overlap(spec, 4)
    got = ops.viterbi_decode_frames(frames, tr, spec, device="cuda",
                                    block_frames=4, overlap=full, **kw)
    assert torch.equal(got, ops.viterbi_decode_frames(frames, tr, spec,
                                                      device="cuda", **kw))
