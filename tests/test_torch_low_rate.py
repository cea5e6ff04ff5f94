"""The fast mappings at rates below 1/8 (beta > 8 at k <= 15), on the CPU.

On the card ``csrc/acs.cuh`` runs these codes on the register mapping with
beta at run time (``VitFrame<R, 0>``, k <= 11) and on the one-block form's
per-edge sums (k = 12-15); ``tests/test_torch_gpu.py`` holds the kernels to
their plain versions there, and ``test_torch_large_codes.py`` the plain
versions to JAX's kernels here. Without a card:

* a plain torch model of the register form's branch metrics: each lane's
  butterfly encoder words (``VitFrame<R, 0>::init``) and the edge words
  made from them, the terms flipped by the words' bits and summed in b
  order four at a time (``vit_word_sums``), one sum where every polynomial
  has both taps; equal to the plain version's ``sgn * bm_half[idx]`` of
  every edge of every state, bit for bit, in f32 and bf16;
* the LLR chunk loader's walk (``vit_recursion_rt``): lane l of a segment
  of P lanes loads the elements l, l + P, ... of a chunk of P beta, and its
  incremental (stage, term) of each is the element's; together the lanes
  fill every row of the chunk once;
* the planner's model of the new kernels against the constants recorded
  from the card: their registers (``H100_REGISTERS``' ``*_lowrate``), the
  one-block form's threads and resident blocks (``H100_BLOCKS``), each
  warp's LLR chunks, and the resident frames these give; and where B1's
  register mapping keeps its survivors (``tile_survivors_on_chip``).

Tolerance: exact.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.framed import FrameSpec
from repro_torch.core.metrics import signed_sum
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune
from repro_torch.kernels.acs import BM_DTYPES
from repro_torch.kernels.tables import kernel_tables

torch.set_num_threads(1)

#: Low-rate codes on the register form (R = 1, 1, 2, 8, 32 registers a
#: lane): K=3 rate 1/9 (a segment of 4 lanes), K=5 rate 1/12 (top taps
#: only), K=7 rate 1/9 and 1/16, K=9 rate 1/10, K=11 rate 1/9 with one
#: polynomial short of its bottom tap (four sums a butterfly).
REGISTER_CODES = [
    (3, (0o7, 0o5, 0o7, 0o5, 0o7, 0o5, 0o7, 0o5, 0o7)),
    (5, (0o21, 0o23, 0o25, 0o27, 0o31, 0o33, 0o35, 0o37, 0o20, 0o22, 0o24,
         0o26)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173)),
    (7, (0o171, 0o133, 0o165, 0o117, 0o127, 0o135, 0o147, 0o155, 0o173,
         0o103, 0o111, 0o125, 0o137, 0o141, 0o153, 0o163)),
    (9, (0o561, 0o753, 0o711, 0o647, 0o525, 0o457, 0o673, 0o535, 0o743,
         0o607)),
    (11, (0o3345, 0o3613, 0o2011, 0o3777, 0o2525, 0o3131, 0o2663, 0o3455,
          0o2002)),
]
#: Low-rate codes of the one-block form: k = 12-15 at rate 1/9 (chip_smoke's
#: timing codes) and a K=13 rate-1/10 code.
BLOCK_CODES = [
    (12, (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163, 0o7555,
          0o4001)),
    (13, (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577, 0o16243,
          0o14101, 0o17017)),
    (13, (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577, 0o16243,
          0o14101, 0o17017, 0o10001)),
    (14, (0o21645, 0o35661, 0o24567, 0o31235, 0o27771, 0o22223, 0o36541,
          0o20003, 0o33333)),
    (15, (0o46321, 0o51271, 0o63667, 0o70535, 0o41111, 0o57773, 0o62345,
          0o77777, 0o40001)),
]


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def _taps(tr):
    """(bot, top, taps) as acs.cuh's vit_taps: bit b the bottom / top tap
    of g_b; taps when every polynomial has both."""
    bot = sum((g & 1) << b for b, g in enumerate(tr.polys))
    top = sum(((g >> (tr.k - 1)) & 1) << b for b, g in enumerate(tr.polys))
    full = (1 << tr.beta) - 1
    return bot, top, bot == full and top == full


def _lane_words(tr):
    """The encoder word of the edges into every state as the register
    form's lanes make them: {(s, p): word}. For R >= 2 lane l's butterfly i
    is the low state 32 i + l and the high state S/2 above it; for R = 1
    the lane's one state, high when l >= S/2."""
    S = tr.num_states
    H = S // 2
    R = max(1, S // 32)
    P = min(S, 32)
    bot, top, _ = _taps(tr)
    words = {}
    for lane in range(32):
        l = lane % P
        for i in range(R // 2 if R >= 2 else 1):
            q = 32 * i + l if R >= 2 else l & (H - 1)
            a = sum(_parity(2 * q & g) << b for b, g in enumerate(tr.polys))
            states = ([(q, 0), (q + H, 1)] if R >= 2
                      else [(l, int(l >= H))])
            for s, h in states:
                for p in (0, 1):
                    w = a ^ (bot if p else 0) ^ (top if h else 0)
                    assert words.setdefault((s, p), w) == w
    assert len(words) == 2 * S
    return words


def _word_sums(x, words, beta, bm_dtype):
    """vit_word_sums over a batch of stages x (F, beta): each word's terms,
    x[b] with its sign flipped by bit b, summed in b order in float32 four
    at a time, the first term taken as it is; rounded once for bf16."""
    out = []
    for w in words:
        acc = None
        for b0 in range(0, beta, 4):
            for j in range(4):
                b = b0 + j
                if b >= beta:
                    break
                t = -x[:, b] if (w >> b) & 1 else x[:, b]
                acc = t if b == 0 else acc + t
        out.append(acc)
    return torch.stack(out, 1).to(BM_DTYPES[bm_dtype]).float()


def _stages(tr, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((1.0 - 2.0 * rng.integers(0, 2, (n, tr.beta))
                             + 0.8 * rng.standard_normal((n, tr.beta)))
                            .astype(np.float32))


@pytest.mark.parametrize("bm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", REGISTER_CODES,
                         ids=lambda c: f"k{c[0]}b{len(c[1])}")
def test_register_form_metrics_equal_compressed_table(code, bm_dtype):
    """The register form's edge metrics from its lanes' words equal the
    plain version's sgn * bm_half[idx] of every edge, bit for bit (zeros of
    either sign alike); with both taps everywhere, one sum a butterfly
    whose negation is its other two edges."""
    tr = make_trellis(*code)
    assert autotune.low_rate(tr) and not autotune.smem_mapping(tr)
    assert not autotune.wide_mapping(tr)
    S, beta = tr.num_states, tr.beta
    _, idx_p, sgn_p, signs_half = kernel_tables(tr)
    x = _stages(tr, 5, 13 * tr.k + beta)
    bm = signed_sum(x, signs_half).to(BM_DTYPES[bm_dtype]).float()
    words = _lane_words(tr)
    keys = sorted(words)
    got = _word_sums(x, [words[key] for key in keys], beta, bm_dtype)
    _, _, taps = _taps(tr)
    for n, (s, p) in enumerate(keys):
        want = float(sgn_p[p][s]) * bm[:, int(idx_p[p][s])]
        assert torch.equal(got[:, n], want), (s, p)
        if taps:             # edge 1 is edge 0's negation: one sum
            assert words[(s, 1)] == words[(s, 0)] ^ ((1 << beta) - 1)
            h = int(s >= S // 2)
            base = s - h * (S // 2)
            assert words[(s, 0)] == words[(base, 0)] ^ (
                ((1 << beta) - 1) if h else 0)


@pytest.mark.parametrize("P", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("beta", [9, 10, 12, 16, 23, 32])
def test_llr_chunk_walk_fills_every_row_once(P, beta):
    """vit_recursion_rt's loader: lane l steps through the elements
    l + P m (m < beta) of a chunk of P stages by (P // beta, P % beta) with
    a carry, and lands on (i // beta, i % beta) of each; the lanes' stores
    cover the chunk's P rows of beta terms once each, inside rows of
    vit_llr_row(beta) floats."""
    row = -(-beta // 4) * 4
    du, db = divmod(P, beta)
    seen = np.zeros((P, row), dtype=int)
    for lane in range(P):
        u, b = divmod(lane, beta)
        for m in range(beta):
            i = lane + P * m
            assert (u, b) == divmod(i, beta)
            seen[u, b] += 1
            b += db
            u += du
            if b >= beta:
                b -= beta
                u += 1
    assert (seen[:, :beta] == 1).all() and (seen[:, beta:] == 0).all()
    # (a code's stand-in: the chunk bytes read beta alone)
    assert autotune.llr_chunk_bytes(SimpleNamespace(beta=beta)) == \
        2 * 32 * row * 4


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("code", REGISTER_CODES + BLOCK_CODES,
                         ids=lambda c: f"k{c[0]}b{len(c[1])}")
def test_low_rate_register_and_thread_models(code, unified):
    """The planner plans the new kernels with the card's constants: the
    register form with ``H100_REGISTERS``' ``*_lowrate`` count and each
    warp's LLR chunks beside the run buffers (B3) or the survivors (B1),
    the resident frames of its tile from threads, block slots, shared
    memory and registers; the one-block form with ``*_block_lowrate``
    registers, its run-time-beta threads (``large_threads``) and
    ``H100_BLOCKS``' ``*_lowrate`` blocks an SM; B3 at K=9
    (``FWD_WIDE_K``) the wide mapping with ``*_wide`` registers."""
    tr = make_trellis(*code)
    name = "unified" if unified else "split"
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    plan = autotune.plan_tiles(tr, spec, pack_survivors=True,
                               unified=unified, device="cpu")
    assert plan.fits and plan.frames_per_sm >= 1
    assert not autotune.wide_mapping(tr) and autotune.low_rate(tr)
    if autotune.wide_mapping(tr, unified):
        assert not unified and tr.k == autotune.FWD_WIDE_K
        regs = autotune.H100_REGISTERS["split_wide"]
        T = autotune.wide_threads(tr)
        assert autotune.block_threads(tr, 1, 1, unified) == T
        assert plan.registers == regs and plan.frames_per_tile == 1
        assert plan.smem_bytes == autotune.WIDE_CORE_BYTES
        assert plan.frames_per_sm == autotune._resident_frames(
            plan.smem_bytes, T, 1, regs, autotune.H100_LIMITS)
        return
    if autotune.smem_mapping(tr):
        T = autotune.large_threads(tr)
        assert T == min(tr.num_states // 2,
                        autotune._LOW_RATE_THREADS[tr.k])
        assert T % 32 == 0 and tr.num_states // 2 // T in (1, 2, 4, 8, 16)
        assert autotune.block_threads(tr, 1) == T
        regs = autotune.H100_REGISTERS[name + "_block_lowrate"]
        assert autotune.kernel_registers(tr, unified=unified,
                                         device="cpu") == regs
        assert plan.registers == regs and plan.frames_per_tile == 1
        blocks = autotune.H100_BLOCKS[name + "_lowrate"][tr.k]
        assert autotune.block_capacity(tr, "cpu", unified=unified) == blocks
        core = autotune.split_smem_bytes(tr, spec, 1)[0]
        if tr.k == autotune.SMEM_MIN_K:    # the registers recorded are k=12's
            assert blocks == autotune._resident_frames(
                core, T, 1, regs, autotune.H100_LIMITS)
        assert autotune.block_grid(tr, 10_000, "cpu", unified=unified) == \
            autotune.H100_SMS * blocks
        return
    regs = autotune.H100_REGISTERS[name + "_lowrate"]
    assert autotune.kernel_registers(tr, unified=unified, device="cpu") \
        == regs == plan.registers
    fpb = plan.frames_per_tile
    threads = autotune.block_threads(tr, fpb)
    chunks = threads // 32 * autotune.llr_chunk_bytes(tr)
    assert dict(plan.breakdown)["llr_chunks"] == chunks
    if unified:         # survivors on chip or in the scratch, as B1 runs
        scratch = not autotune.tile_survivors_on_chip(
            tr, spec, fpb, pack_survivors=True, device="cpu")
        assert plan.smem_bytes == autotune.unified_smem_bytes(
            tr, spec, fpb, pack_survivors=True, scratch=scratch)[0]
    else:
        assert plan.smem_bytes == autotune.split_smem_bytes(
            tr, spec, fpb, pack_survivors=True)[0]
    assert plan.frames_per_sm == autotune._resident_frames(
        plan.smem_bytes, threads, fpb, regs, autotune.H100_LIMITS)
    if not unified:
        assert plan.smem_bytes == threads // 32 * 256 + chunks


def test_b1_survivors_leave_shared_memory_where_they_cost_frames():
    """B1's register mapping keeps a block's survivors and starts on chip
    unless that keeps fewer of the launch's frames resident than the
    device-memory scratch would (``tile_survivors_on_chip``, the one-block
    form's rule): the main K=7 shape keeps them on chip at any frame count;
    K=11 at rate 1/9 (41 KB of packed survivors a frame, 5 frames an SM
    where its registers leave 32) on chip for 8 frames, in the scratch for
    1056, and the planner plans the launch so."""
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    k7 = make_trellis(7, (0o171, 0o133))
    for F in (8, 16384, None):
        assert autotune.tile_survivors_on_chip(
            k7, spec, 8, pack_survivors=True, frames=F, device="cpu")
    k11 = make_trellis(*REGISTER_CODES[-1])
    lim = autotune.H100_LIMITS
    regs = autotune.H100_REGISTERS["unified_lowrate"]
    on = autotune.unified_smem_bytes(k11, spec, 1, pack_survivors=True)[0]
    off = autotune.unified_smem_bytes(k11, spec, 1, pack_survivors=True,
                                      scratch=True)[0]
    assert on == off + 32 + spec.frame_len * 128     # 8 starts, survivors
    assert autotune._resident_frames(on, 32, 1, regs, lim) == 5
    assert autotune._resident_frames(off, 32, 1, regs, lim) == 32
    assert autotune.tile_survivors_on_chip(
        k11, spec, 1, pack_survivors=True, frames=8, device="cpu")
    assert not autotune.tile_survivors_on_chip(
        k11, spec, 1, pack_survivors=True, frames=1056, device="cpu")
    plan = autotune.plan_tiles(k11, spec, pack_survivors=True,
                               max_frames=1056, device="cpu")
    assert dict(plan.breakdown)["sel_survivors"] == 0
    assert plan.frames_per_sm == autotune._resident_frames(
        plan.smem_bytes, autotune.block_threads(k11, plan.frames_per_tile),
        plan.frames_per_tile, regs, lim) >= 32
