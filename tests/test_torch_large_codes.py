"""Codes past the fast mappings' compile-time domain (k >= 16, or beta >= 9
at any k): the port's plain versions against the JAX package's kernels,
on the CPU.

On the card the codes past k = 15 run the wide mapping of
``csrc/acs.cuh`` in both ACS kernels, and the rates below 1/8 at k <= 15
the fast mappings with beta at run time (the register mapping to k = 11,
the one-block form's per-edge sums at k = 12-15); the traceback kernel
chases them all. ``tests/test_torch_gpu.py`` holds each kernel to the
plain versions here. The
same numpy inputs, made from a seed, go through JAX's
``unified_decode_frames`` and ``forward_frames`` (the Pallas kernels in
interpret mode, as the JAX tests run them), its ``core.traceback`` chases
and its ``make_decoder``, and through their port counterparts on the CPU.
Tolerance: exact (bits, sel and amax equal, with equal shapes and dtypes).

Codes: k = 16 and 17 at rate 1/2, k = 16 at rate 1/3, k = 7 at rate 1/9,
k = 5 at rate 1/12, k = 9 at rate 1/10 and k = 13 at rate 1/9. Their
polynomials are distinct and set the top and the bottom tap, except
k = 5, which has only 8 such polynomials: its 12 are distinct and set the
top tap. Each JAX call runs in interpret mode
(about a second at k = 16), so the knobs are spread over the calls: every
unified call is compared with the port's plain version at pack x layout x
radix, and bf16 branch metrics take one start of each code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FrameSpec as JFrameSpec
from repro.core import pipeline as jpipe
from repro.core import traceback as jtb
from repro.core.framed import frame_llr as jframe_llr
from repro.core.trellis import make_trellis as jmake_trellis
from repro.kernels import autotune as jautotune
from repro.kernels import tables as jtables
from repro.kernels.viterbi_fwd import forward_frames as jforward_frames
from repro.kernels.viterbi_unified import (
    unified_decode_frames as junified_decode_frames)

from repro_torch.core import traceback as ttb
from repro_torch.core.encoder import encode_bits
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune, tables
from repro_torch.kernels import traceback_frames as tbf
from repro_torch.kernels import viterbi_fwd as vf
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.kernels.packing import Layout

from _torch_parity import jcfg

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

K16 = (16, (0o135417, 0o163251))
K17 = (17, (0o247153, 0o365715))
K16B3 = (16, (0o135417, 0o163251, 0o117643))
K7B9 = (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155,
            0o173))
K5B12 = (5, (0o21, 0o23, 0o25, 0o27, 0o31, 0o33, 0o35, 0o37, 0o20, 0o22,
             0o24, 0o26))
K9B10 = (9, (0o561, 0o753, 0o711, 0o647, 0o525, 0o457, 0o673, 0o535,
             0o743, 0o607))
K13B9 = (13, (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577,
              0o16243, 0o14101, 0o17017))
CODES = [K16, K17, K16B3, K7B9, K5B12, K9B10, K13B9]
#: serial, boundary and fixed starts
SPECS = [FrameSpec(f=16, v1=8, v2=8),
         FrameSpec(f=16, v1=8, v2=8, f0=8, v2s=8),
         FrameSpec(f=24, v1=8, v2=12, f0=8, v2s=6, start="fixed")]
#: the port's knob grid for every JAX call: (pack, layout, radix)
GRID = [(p, lay, r) for p in (False, True) for lay in ("lane", "sublane")
        for r in (2, 4)]
F = 2


def _frames(code, spec, seed, snr=6.0):
    """F noisy frames of a random codeword, the same for both packages:
    (torch (F, L, beta), jax)."""
    rng = np.random.default_rng(seed)
    tr = make_trellis(*code)
    coded = encode_bits(rng.integers(0, 2, F * spec.f), tr)
    sigma = 10.0 ** (-snr / 20.0)
    llr = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)
           ).astype(np.float32)
    return (frame_llr(torch.from_numpy(llr), spec),
            jframe_llr(jnp.asarray(llr), JFrameSpec(**vars(spec))))


def _geometry(spec):
    """(f0, v2s, start) as the kernels take them: serial = one subframe."""
    if spec.parallel_tb:
        return spec.f0, spec.v2s, spec.start
    return spec.f, spec.v2, "boundary"


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("code", CODES)
def test_codes_are_past_the_fast_mappings(code):
    """Each code is past the fast mappings' compile-time domain: past
    k = 15 it runs the wide mapping; past beta = 8 at k <= 15 a fast
    mapping with beta at run time (the register mapping to k = 11, the
    one-block form from k = 12), but B3 at K=9 (``FWD_WIDE_K``) the wide
    mapping. Its polynomials are distinct and set the top tap, and past
    k = 5 the bottom one."""
    tr = make_trellis(*code)
    assert len(set(tr.polys)) == tr.beta
    assert tr.k > autotune.MAX_K or tr.beta > autotune.MAX_BETA
    assert autotune.wide_mapping(tr) == (tr.k > autotune.MAX_K)
    assert autotune.wide_mapping(tr, unified=False) == (
        tr.k > autotune.MAX_K or tr.k == autotune.FWD_WIDE_K)
    assert autotune.low_rate(tr) == (tr.beta > autotune.MAX_BETA)
    assert autotune.smem_mapping(tr) == (
        autotune.SMEM_MIN_K <= tr.k <= autotune.MAX_K)
    assert all(g >> (tr.k - 1) == 1 for g in tr.polys)
    if tr.k > 5:
        assert all(g & 1 for g in tr.polys)


@pytest.mark.parametrize("code", [K16, K17, K7B9, K5B12, K9B10, K13B9])
def test_host_tables_equal_jax(code):
    """kernels/tables.py's host tables equal JAX's in-kernel ones: int32
    indices into a signs_half of (2^(beta-1), beta)."""
    got = tables.kernel_tables(make_trellis(*code))
    want = jtables.kernel_tables(jmake_trellis(*code))
    for g, w in zip(got[:3], want[:3]):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, np.asarray(wp))
            assert gp.dtype == np.asarray(wp).dtype
    half = 1 << (len(code[1]) - 1)
    assert got[3].shape == (half, len(code[1]))
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    assert got[1][0].dtype == np.int32 and got[1][0].max() < half


@pytest.mark.parametrize("si", range(len(SPECS)))
@pytest.mark.parametrize("code", CODES)
def test_unified_equals_jax_kernel(code, si):
    """The unified kernel's plain version equals JAX's Pallas kernel at
    every (pack, layout, radix); the boundary start in bf16."""
    spec = SPECS[si]
    f0, v2s, start = _geometry(spec)
    bm = "bfloat16" if si == 1 else "float32"
    tf, jf = _frames(code, spec, 11 + si)
    kw = dict(v1=spec.v1, f=spec.f, v2=spec.v2, f0=f0, v2s=v2s, start=start,
              frames_per_tile=1, bm_dtype=bm)
    pack, layout, radix = GRID[(si + len(code[1])) % len(GRID)]
    want = np.asarray(junified_decode_frames(
        jf, trellis=jmake_trellis(*code), pack_survivors=pack,
        layout=layout, radix=radix, interpret=True, **kw))
    for pack, layout, radix in GRID:
        _same(vu.unified_decode_frames(tf, trellis=make_trellis(*code),
                                       pack_survivors=pack, layout=layout,
                                       radix=radix, **kw), want)


@pytest.mark.parametrize("knobs", [(True, "sublane", "bfloat16"),
                                   (False, "lane", "float32")])
@pytest.mark.parametrize("code", CODES)
def test_forward_and_tracebacks_equal_jax(code, knobs):
    """The forward kernel's plain version equals JAX's Pallas kernel (sel
    and amax, in JAX's shape and dtype) at radix 2 and 4; the split
    traceback (``traceback_frames`` and ``core.traceback``'s serial and
    parallel chases) on it equals JAX's on JAX's stream."""
    pack, layout, bm = knobs
    spec = SPECS[1]
    tf, jf = _frames(code, spec, 21)
    fkw = dict(frames_per_tile=1, pack_survivors=pack, layout=layout,
               bm_dtype=bm)
    jtr = jmake_trellis(*code)
    jsel, jamax = (np.asarray(a) for a in jforward_frames(
        jf, trellis=jtr, radix=4 if pack else 2, interpret=True, **fkw))
    tr = make_trellis(*code)
    for radix in (2, 4):
        sel, amax = vf.forward_frames(tf, trellis=tr, radix=radix, **fkw)
        _same(sel, jsel)
        _same(amax, jamax)
    lay = Layout(layout)
    from repro.kernels.packing import Layout as JLayout
    jlay = JLayout(layout)
    L = spec.frame_len
    for f0, v2s, start in ((spec.f, L - spec.v1 - spec.f, "boundary"),
                           (spec.f0, spec.v2s, "boundary"),
                           (spec.f0, spec.v2s - 2, "fixed")):
        tkw = dict(v1=spec.v1, f=spec.f, f0=f0, v2s=v2s, start=start,
                   packed=pack, layout=layout)
        got = tbf.traceback_frames(sel, amax, trellis=tr, **tkw)
        want = np.asarray(jtb.parallel_traceback_frames(
            jnp.asarray(jsel), jnp.asarray(jamax), jtr, spec.v1, spec.f, f0,
            v2s, start, packed=pack, layout=jlay))
        _same(got, want)
        _same(ttb.parallel_traceback_frames(sel, amax, tr, spec.v1, spec.f,
                                            f0, v2s, start, packed=pack,
                                            layout=lay), want)
    _same(ttb.serial_traceback_frames(sel, amax, tr, spec.v1, spec.f,
                                      packed=pack, layout=lay),
          jtb.serial_traceback_frames(jnp.asarray(jsel), jnp.asarray(jamax),
                                      jtr, spec.v1, spec.f, packed=pack,
                                      layout=jlay))


@pytest.mark.parametrize("backend", ["kernel", "kernel_split"])
@pytest.mark.parametrize("code", [K16, K7B9])
def test_make_decoder_equals_jax(code, backend):
    """make_decoder's kernel backends on the CPU against JAX's, on one
    received stream of three and a half frames."""
    tr = make_trellis(*code)
    spec = FrameSpec(f=32, v1=8, v2=16, f0=16, v2s=12)
    cfg = DecoderConfig(trellis=tr, spec=spec, backend=backend)
    n = 3 * 32 + 17
    rng = np.random.default_rng(31)
    coded = encode_bits(rng.integers(0, 2, n), tr)
    stream = (1.0 - 2.0 * coded + 0.5 * rng.standard_normal(coded.shape)
              ).astype(np.float32)
    got = make_decoder(cfg, "cpu")(stream, n)
    want = np.asarray(jpipe.make_decoder(jcfg(cfg))(stream, n))
    _same(got, want)


@pytest.mark.parametrize("unified", [True, False])
def test_planner_plans_every_code(unified):
    """plan_tiles returns a fitting plan for every code on the H100's
    limits, as JAX's planner returns one for any code. Past k = 15 one frame
    on the wide mapping: its core and, to k = 15, its path metrics; at
    16 <= k <= 19 one block of a cluster of C = 2^(k-15): the cluster core
    and its 8 S / C bytes of path metrics. Past beta = 8 at k <= 11 the
    register mapping's tile with each warp's LLR chunks (B3 at K=9, one
    frame on the wide mapping), at k = 12-15 one frame a block of the
    one-block form, with the registers and resident blocks of their
    run-time-beta kernels."""
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    name = "unified" if unified else "split"
    for code in CODES:
        tr = make_trellis(*code)
        plan = autotune.plan_tiles(tr, spec, pack_survivors=True,
                                   unified=unified, device="cpu")
        jplan = jautotune.plan_tiles(jmake_trellis(*code),
                                     JFrameSpec(**vars(spec)),
                                     pack_survivors=True, unified=unified)
        assert jplan.frames_per_tile >= 1
        assert plan.fits and plan.frames_per_sm >= 1
        assert plan.budget == autotune.H100_LIMITS.smem_per_block
        C = autotune.wide_cluster(tr, "cpu", unified=unified)
        assert C == (1 << (tr.k - 15) if 16 <= tr.k <= 19 else 1)
        if not autotune.wide_mapping(tr, unified):
            assert autotune.low_rate(tr) and autotune.llr_chunk_bytes(tr) \
                == 2 * 32 * (-(-tr.beta // 4) * 4) * 4
            if autotune.smem_mapping(tr):
                assert plan.frames_per_tile == 1
                assert plan.registers == \
                    autotune.H100_REGISTERS[name + "_block_lowrate"]
                assert plan.frames_per_sm == \
                    autotune.H100_BLOCKS[name + "_lowrate"][tr.k]
                assert autotune.block_threads(tr, 1) == \
                    autotune.large_threads(tr)
            else:
                assert plan.registers == \
                    autotune.H100_REGISTERS[name + "_lowrate"]
                warps = autotune.block_threads(
                    tr, plan.frames_per_tile) // 32
                assert dict(plan.breakdown)["llr_chunks"] == \
                    warps * autotune.llr_chunk_bytes(tr)
                assert autotune.max_frames_per_block(tr) == \
                    8 * (32 // min(32, tr.num_states))
            continue
        if C > 1:
            pm, core = 8 * tr.num_states // C, autotune.CLUSTER_CORE_BYTES
        else:
            pm, core = 0, autotune.WIDE_CORE_BYTES
        assert plan.frames_per_tile == 1
        assert plan.smem_bytes == core + pm
        assert dict(plan.breakdown)["sel_survivors"] == 0
        assert plan.registers == autotune.H100_REGISTERS[
            name + ("_cluster" if C > 1 else "_wide")]
        assert autotune.block_threads(tr, 1, 1, unified) == \
            autotune.wide_threads(tr) == max(32, min(1024, tr.num_states // 2))
        if C > 1:
            assert autotune.block_threads(tr, 1, C) == \
                autotune.cluster_threads(tr, C) == 512
        assert autotune.max_frames_per_block(tr, unified) == 1
        assert not autotune.smem_mapping(tr)
    # k = 16 on the H100: clusters of two 512-thread blocks, one an SM
    # pair, one frame a cluster; off a cluster one block an SM
    tr = make_trellis(*K16)
    assert autotune.wide_grid(tr, 10_000, "cpu") == \
        autotune.H100_CLUSTERS[2] <= autotune.H100_SMS // 2
    assert autotune.wide_grid(tr, 7, "cpu") == 7
    assert autotune.wide_grid(tr, 10_000, "cpu", cluster=1) == \
        autotune.H100_SMS
