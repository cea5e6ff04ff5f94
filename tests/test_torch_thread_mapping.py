"""B1's thread mapping (one thread a frame, 3 <= k <= 7), on the CPU.

On the card ``csrc/viterbi_unified.cu``'s ``VitThread`` keeps a frame's
S = 2^(k-1) path metrics in one thread's registers; ``tests/
test_torch_gpu_thread_mapping.py`` holds the kernel to the plain version
and to the warp mapping there. Without a card, a numpy model of the
kernel, stage by stage as it runs:

* the registers: the butterfly (2j, 2j+1) -> (j, j + S/2) writes into
  the registers of its inputs, so state s lies in register s rotated left
  by one bit after a stage's butterflies, and the stage's end puts it
  back;
* each butterfly's metric from the edge coefficients
  (``thread_coefficients``: +-1 at the edge's half metric, 0 elsewhere),
  summed as the kernel sums them, equal to the plain version's
  ``sgn * bm_half[idx]`` in both generator orders of the K=7 cells; where
  every polynomial has both taps, edges 01 and 10 are edge 00 negated and
  edge 11 edge 00;
* the survivors as LANE words in a ring of ``thread_ring_slots`` stages,
  equal to ``pack_bits`` of the plain recursion's selectors stage by
  stage, and each start's traceback from that ring, whose bits equal
  ``unified_decode_frames_plain``'s at K=3, 5, 6 and 7;
* the planner's model of the mapping against its constants.

Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.framed import FrameSpec
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune
from repro_torch.kernels.acs import acs_scan
from repro_torch.kernels.packing import pack_bits
from repro_torch.kernels.tables import kernel_tables
from repro_torch.kernels.viterbi_fwd import forward_frames_cuda
from repro_torch.kernels.viterbi_unified import (
    both_taps, thread_coefficients, unified_decode_frames_cuda,
    unified_decode_frames_plain)

torch.set_num_threads(1)

#: K=3, K=4 rate 1/3, K=5, K=6, the K=7 cells' code in both generator
#: orders (CCSDS 171, 133; IEEE 802.11 133, 171), K=7 rate 1/3, and two
#: codes with a polynomial short of a tap (four metrics a butterfly).
CODES = [(3, (0o7, 0o5)), (4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
         (6, (0o65, 0o57)), (7, (0o171, 0o133)), (7, (0o133, 0o171)),
         (7, (0o171, 0o133, 0o165)), (5, (0o23, 0o16)),
         (7, (0o133, 0o070))]


def _rotl(s, u, k):
    """vit_thread_reg: s rotated left by u bits of k - 1."""
    n = k - 1
    return ((s << u) | (s >> (n - u))) & ((1 << n) - 1) if u else s


def _bf16(x):
    """float32 -> bfloat16 (nearest even) -> float32, as __float2bfloat16_rn."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _half_metrics(x, beta, bf16):
    """VitThread::step's half metrics: x[0], then one rounded add or
    subtract a term, in b order."""
    out = []
    for h in range(1 << (beta - 1)):
        acc = x[:, 0].copy()
        for b in range(1, beta):
            acc = (acc - x[:, b]) if (h >> (beta - 1 - b)) & 1 else \
                (acc + x[:, b])
        out.append(_bf16(acc) if bf16 else acc)
    return out


def _edge(coef, e, s, bm):
    """VitThread::edge: a multiply, then an fma a half metric."""
    m = np.float32(coef[e, s, 0]) * bm[0]
    for h in range(1, len(bm)):
        m = np.float32(coef[e, s, h]) * bm[h] + m
    return m.astype(np.float32)


def thread_model(frames, trellis, *, v1, f, f0, v2s, start="boundary",
                 bm_dtype="float32", trace=None):
    """The thread mapping's decode of (F, L, beta) float32 frames, as
    the kernel runs it: one stage at a time, the butterflies in place in
    the registers of their inputs, then every state back in its own
    register; survivor words in a ring of Z = f0 + v2s stages [Z][W][F];
    each start traced back at once. ``trace(t, words)`` sees each
    stage's (W, F) words."""
    k, beta, S = trellis.k, trellis.beta, trellis.num_states
    F, L, _ = frames.shape
    W = autotune.thread_ring_words(trellis)
    Z = autotune.thread_ring_slots(f0, v2s)
    T = f0 + v2s
    coef = thread_coefficients(trellis)
    taps = both_taps(trellis)
    last = v1 + f + v2s
    pm = np.zeros((F, S), dtype=np.float32)          # registers
    ring = np.zeros((Z, W, F), dtype=np.uint64)
    out = np.zeros((F, f), dtype=np.int32)
    next_e, q, slot = v1 + f0 - 1 + v2s, 0, 0
    back = [_rotl(s, 1, k) for s in range(S)]       # vit_thread_reg
    for t in range(last):
        bm = _half_metrics(frames[:, t], beta, bm_dtype == "bfloat16")
        w = np.zeros((W, F), dtype=np.uint64)
        for j in range(S // 2):
            a, b = pm[:, 2 * j], pm[:, 2 * j + 1]
            if taps:
                m = _edge(coef, 0, j, bm)
                c00, c01, c10, c11 = a + m, b - m, a - m, b + m
            else:
                c00 = a + _edge(coef, 0, j, bm)
                c01 = b + _edge(coef, 1, j, bm)
                c10 = a + _edge(coef, 0, j + S // 2, bm)
                c11 = b + _edge(coef, 1, j + S // 2, bm)
            s0, s1 = c01 >= c00, c11 >= c10
            pm[:, 2 * j] = np.where(s0, c01, c00)          # state j
            pm[:, 2 * j + 1] = np.where(s1, c11, c10)      # state j + S/2
            w[0] |= s0.astype(np.uint64) << np.uint64(j)
            w[W - 1] |= s1.astype(np.uint64) << np.uint64(
                j if W == 2 else j + S // 2)
        pm = pm[:, back] - pm.max(axis=1, keepdims=True)
        ring[slot] = w
        if trace is not None:
            trace(t, w)
        if t == next_e:
            state = (np.zeros(F, dtype=np.int64) if start == "fixed" else
                     np.argmax(pm == 0, axis=1).astype(np.int64))
            z = slot
            for r in range(T):
                if r >= v2s:
                    out[:, q * f0 + f0 - 1 - (r - v2s)] = state >> (k - 2)
                word = ring[z, state >> 5 if W == 2 else 0, np.arange(F)]
                bit = (word >> (state & 31).astype(np.uint64)) & 1
                state = ((state << 1) & (S - 1)) | bit.astype(np.int64)
                z = z - 1 if z else Z - 1
            q += 1
            next_e = next_e + f0 if next_e + f0 < last else -1
        slot = slot + 1 if slot + 1 < Z else 0
    return out


def _frames(trellis, F, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((F, L, trellis.beta)) * 2.0
            + 0.5).astype(np.float32)


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
def test_registers_after_the_butterflies(k):
    """The butterflies of a stage write each register once, into the
    registers of their inputs: state s then lies in register rotl(s, 1)
    (vit_thread_reg), which the stage's end puts back; after k - 1 such
    stages without it every state would be home again."""
    S = 1 << (k - 1)
    where = list(range(S))                # where[s]: register of state s
    for u in range(k - 1):
        assert where == [_rotl(s, u, k) for s in range(S)]
        nxt = [None] * S
        for j in range(S // 2):
            nxt[j] = where[2 * j]
            nxt[j + S // 2] = where[2 * j + 1]
        assert sorted(nxt) == list(range(S))
        if u == 0:
            assert nxt == [_rotl(s, 1, k) for s in range(S)]
        where = nxt
    assert where == list(range(S))


@pytest.mark.parametrize("code", CODES, ids=str)
@pytest.mark.parametrize("bm_dtype", ["float32", "bfloat16"])
def test_edge_coefficients_give_the_compressed_table(code, bm_dtype):
    """Every edge's sum over the coefficients equals sgn_p[s] *
    bm_half[idx_p[s]] of the plain version, in both generator orders;
    with both taps edges 01 and 10 are edge 00's negation and edge 11
    edge 00."""
    trellis = make_trellis(*code)
    S, beta = trellis.num_states, trellis.beta
    _, idx_p, sgn_p, signs_half = kernel_tables(trellis)
    x = _frames(trellis, 64, 1, 3)[:, 0]
    bm = _half_metrics(x, beta, bm_dtype == "bfloat16")
    want_half = np.stack(bm, 1)
    plain = x[:, 0:1] * signs_half[:, 0]
    for b in range(1, beta):
        plain = plain + x[:, b:b + 1] * signs_half[:, b]
    if bm_dtype == "bfloat16":
        plain = _bf16(plain)
    np.testing.assert_array_equal(want_half, plain)
    coef = thread_coefficients(trellis)
    assert coef.shape == (2, S, 1 << (beta - 1))
    assert set(np.unique(np.abs(coef))) <= {0.0, 1.0}
    assert (np.abs(coef).sum(-1) == 1).all()
    for p in (0, 1):
        for s in range(S):
            np.testing.assert_array_equal(
                _edge(coef, p, s, bm), sgn_p[p][s] * want_half[:, idx_p[p][s]])
    if both_taps(trellis):
        for j in range(S // 2):
            m = _edge(coef, 0, j, bm)
            np.testing.assert_array_equal(_edge(coef, 1, j, bm), -m)
            np.testing.assert_array_equal(_edge(coef, 0, j + S // 2, bm), -m)
            np.testing.assert_array_equal(_edge(coef, 1, j + S // 2, bm), m)


def test_the_k7_cells_take_both_taps_in_opposite_orders():
    """The two K=7 cells' codes have both taps, and their half-metric
    indices agree while their signs differ: the kernel reads them from the
    coefficients and specialises on neither."""
    a, b = make_trellis(7, (0o171, 0o133)), make_trellis(7, (0o133, 0o171))
    assert both_taps(a) and both_taps(b)
    assert not both_taps(make_trellis(5, (0o23, 0o16)))
    ca, cb = thread_coefficients(a), thread_coefficients(b)
    np.testing.assert_array_equal(np.abs(ca).argmax(-1),
                                  np.abs(cb).argmax(-1))
    assert not np.array_equal(ca, cb)


@pytest.mark.parametrize("code", [CODES[0], CODES[2], CODES[4], CODES[5],
                                  CODES[7]], ids=str)
def test_ring_words_are_the_lane_words(code):
    """Each stage's survivor words equal pack_bits of the plain
    recursion's selectors (state s at bit s % 32 of word s / 32)."""
    trellis = make_trellis(*code)
    v1, f, v2, f0, v2s = 6, 24, 9, 8, 9
    x = _frames(trellis, 5, v1 + f + v2, 7)
    want = {}

    def store(t, sel, sigma):
        want[t] = pack_bits(sel).numpy().astype(np.int64) & 0xFFFFFFFF

    acs_scan(torch.from_numpy(x), trellis=trellis, L=x.shape[1], radix=2,
             store=store)
    seen = []

    def trace(t, words):
        if t < x.shape[1]:
            np.testing.assert_array_equal(words.T.astype(np.int64), want[t])
            seen.append(t)

    thread_model(x, trellis, v1=v1, f=f, f0=f0, v2s=v2s, trace=trace)
    assert seen[:v1 + f + v2s] == list(range(v1 + f + v2s))


KNOBS = [dict(), dict(bm_dtype="bfloat16"), dict(start="fixed"),
         dict(serial=True), dict(f0=4, v2s=5), dict(f0=1, v2s=3),
         dict(f0=2, v2s=0)]


@pytest.mark.parametrize("code", [CODES[0], CODES[2], CODES[3], CODES[4],
                                  CODES[5], CODES[6], CODES[8]], ids=str)
@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_thread_model_equals_plain_version(code, knobs):
    """The model's bits equal unified_decode_frames_plain's at K=3, 5, 6
    and 7, with boundary, fixed and serial starts, bf16 branch metrics,
    and f0 shorter than a run (several starts a run, none past the last:
    f0 = 1, 2, 4, v2s = 0)."""
    trellis = make_trellis(*code)
    kn = dict(knobs)
    v1, f, v2 = 10, 48, 13
    f0, v2s = kn.pop("f0", 12), kn.pop("v2s", 13)
    if kn.pop("serial", False):
        f0, v2s = f, v2
    x = _frames(trellis, 6, v1 + f + v2, 11)
    want = unified_decode_frames_plain(
        torch.from_numpy(x), trellis=trellis, v1=v1, f=f, v2=v2, f0=f0,
        v2s=v2s, frames_per_tile=1, pack_survivors=True, **kn)
    got = thread_model(x, trellis, v1=v1, f=f, f0=f0, v2s=v2s, **kn)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("code", CODES, ids=str)
def test_mapping_is_chosen_from_k_and_beta(code):
    """B1 takes the thread mapping at 3 <= k <= 7 and beta <= 3 whatever
    the polynomials; B3 keeps the warp mapping."""
    trellis = make_trellis(*code)
    want = 3 <= trellis.k <= 7 and trellis.beta <= autotune.THREAD_MAX_BETA
    assert autotune.thread_mapping(trellis) == want
    assert autotune.b1_mapping(trellis) == ("thread" if want else "warp")
    assert autotune.b1_mapping(trellis, unified=False) == "warp"
    assert not autotune.thread_mapping(trellis, unified=False)
    for k, polys, name in ((2, (0o3, 0o1), "warp"), (8, (0o371, 0o247), "warp"),
                           (7, (0o171,) * 4, "warp"),
                           (12, (0o4335, 0o5723), "block"),
                           (17, (0o247153, 0o365715), "cluster"),
                           (20, (0o4000001, 0o7654321), "wide")):
        assert autotune.b1_mapping(make_trellis(k, polys)) == name


#: Launch sizes around the card's threshold (64 frames an SM of the
#: H100's 132: 8,448), the cells' calls and the server's and the stream's.
FRAME_COUNTS = [1, 64, 4096, 8432, 8441, 8447, 8448, 16384, 65536, 66624]


@pytest.mark.parametrize("code", CODES[:7], ids=str)
@pytest.mark.parametrize("frames", FRAME_COUNTS)
def test_mapping_takes_launches_that_fill_the_card(code, frames):
    """A launch takes the thread mapping from 64 frames an SM, counted in
    whole blocks of the warp mapping; the planner plans the mapping the
    launch takes (its tile, threads and registers), and the frame count
    padded to the planned tile takes the same mapping as the count the
    planner saw."""
    trellis = make_trellis(*code)
    cap = autotune.max_frames_per_block(trellis, warp=True)
    want = -(-frames // cap) * cap >= 64 * autotune.H100_SMS == 8448
    assert autotune.THREAD_MIN_FRAMES_PER_SM == 64
    assert autotune.thread_mapping(trellis, frames=frames,
                                   device="cpu") == want
    assert autotune.b1_mapping(trellis, frames=frames, device="cpu") == (
        "thread" if want else "warp")
    spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
    plan = autotune.plan_tiles(trellis, spec, pack_survivors=True, radix=4,
                               max_frames=frames, device="cpu")
    assert plan.registers == autotune.H100_REGISTERS[
        "unified_thread" if want else "unified"]
    ft = plan.frames_per_tile
    assert ft <= (autotune.max_frames_per_block(trellis) if want else cap)
    assert autotune.block_threads(trellis, ft, warp=not want) == (
        ft if want else -(-ft * min(trellis.num_states, 32) // 32) * 32)
    padded = -(-frames // ft) * ft
    assert autotune.thread_mapping(trellis, frames=padded,
                                   device="cpu") == want


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("geometry", [(32, 45), (256, 45), (5, 6)])
def test_ring_model_equals_the_kernel_constants(k, geometry):
    """The ring's slots (a start's f0 + v2s stages), words and shared
    memory as viterbi_unified.cu counts them (padded to 16 bytes, then two
    LLR chunks a warp); the tile's threads, lanes and the thread cap."""
    f0, v2s = geometry
    trellis = make_trellis(k, ((1 << k) - 1, (1 << k) - 3))
    Z = autotune.thread_ring_slots(f0, v2s)
    assert Z == f0 + v2s
    W = autotune.thread_ring_words(trellis)
    assert W == (2 if k == 7 else 1)
    spec = FrameSpec(f=f0 * 4, v1=20, v2=max(v2s, 1), f0=f0, v2s=v2s)
    for ft in (1, 32, 33, 256):
        chunks = -(-ft // 32) * 2 * 32 * (8 * trellis.beta + 2) * 4
        assert autotune.thread_llr_bytes(trellis, ft) == chunks
        total, breakdown = autotune.unified_smem_bytes(trellis, spec, ft)
        assert breakdown == (("survivor_ring", -(-4 * Z * W * ft // 16) * 16),
                             ("llr_chunks", chunks))
        # no ring off the chip: the scratch is the warp mapping's block
        assert autotune.unified_smem_bytes(
            trellis, spec, ft, scratch=True)[1] == (("traceback_starts", 0),
                                                   ("sel_survivors", 0))
        assert autotune.block_threads(trellis, ft) == ft
    assert autotune.lanes_per_frame(trellis) == 1
    assert autotune.lanes_per_frame(trellis, unified=False) == min(
        trellis.num_states, 32)
    assert autotune.max_frames_per_block(trellis) == autotune.BLOCK_THREADS
    assert autotune.max_frames_per_block(trellis, warp=True) == \
        autotune.max_frames_per_block(trellis, unified=False)
    assert autotune.kernel_registers(trellis, device="cpu") == \
        autotune.H100_REGISTERS["unified_thread"]


def test_wrapper_checks_the_private_hooks_before_the_card():
    """A CPU tensor is refused before the card on either mapping
    (``_warp`` off and on); the launch counters by mapping start at every
    mapping's name, and each wrapper's last launch is one of them."""
    frames = torch.zeros((2, 30, 2))
    kw = dict(trellis=make_trellis(7, (0o171, 0o133)), v1=5, f=20, v2=5,
              f0=10, v2s=5, frames_per_tile=2)
    for warp in (False, True):
        with pytest.raises(ValueError, match="CUDA device"):
            unified_decode_frames_cuda(frames, _warp=warp, **kw)
    names = {"thread", "warp", "block", "cluster", "wide"}
    assert set(unified_decode_frames_cuda.mapping_launches) == names
    assert unified_decode_frames_cuda.last_mapping in names | {None}
    assert forward_frames_cuda.last_mapping in names - {"thread"} | {None}
