"""The cluster mapping of the wide ACS kernels (16 <= k <= 19) and its
one-block form (12 <= k <= 15), on the CPU.

On the card ``csrc/acs.cuh``'s ``VitCluster`` runs one frame on a
thread-block cluster of C blocks that exchange path metrics through
distributed shared memory, or, for the large codes, on one block alone
(C = 1); ``tests/test_torch_gpu.py`` holds the kernels to their plain
versions there. Here, without a card:

* the planner: C = 2, 4, 8, 16 at k = 16-19 and 1 elsewhere, each block's
  shared memory within the H100's 227 KB, ``wide_grid`` counting
  clusters and never more than the frames;
* a plain torch model of the kernel's ownership map (which block reads and
  writes which states, the block partials of the stage max and of the
  first maximal state, the survivor words each block stores), run through
  a few stages at K=8-10 on clusters of 2, 4 and 8 blocks: every new state
  and every survivor word is written exactly once, and the selectors,
  first maxima and path metrics equal ``acs.py``'s plain recursion (held
  against the JAX package's by test_torch_kernels.py) bit for bit;
* the same model on one block (C = 1: the one-block form's exchange into
  its own buffer, ``large_threads`` threads whose warps store the survivor
  words) at k = 12-15, beta 2, 8 and 9-10 (the per-edge sums past
  beta = 8), f32 and bf16 branch metrics.

Every model builds its branch metrics as the kernels do: a table of the
four edges of each butterfly from its encoder word, summed term by term in
b order (acs.cuh ``vit_quad``), or, where every polynomial has its top and
bottom taps, one metric and its negation (``vit_edge0``); equal to the
plain version's compressed table ``sgn * bm_half[idx]`` bit for bit.

Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.metrics import signed_sum
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune
from repro_torch.kernels import viterbi_fwd as vf
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.kernels.acs import BM_DTYPES, acs_scan
from repro_torch.kernels.packing import pack_bits, packed_width
from repro_torch.kernels.tables import kernel_tables

torch.set_num_threads(1)

#: Rate-1/2 codes, distinct polynomials with the top and bottom taps set.
CODES = {8: (0o247, 0o371), 9: (0o561, 0o753), 10: (0o1167, 0o1545),
         16: (0o135417, 0o163251), 17: (0o247153, 0o365715),
         18: (0o523571, 0o634657), 19: (0o1234567, 0o1654321)}
#: The large codes at rates 1/2 and 1/8: K=12, 13, 14 and the first two
#: of Galileo's K=15 polynomials at rate 1/2; at rate 1/8 the K=12 code of
#: chip_smoke.py (both taps everywhere: one metric a butterfly) and, at
#: k = 13-15, eight polynomials of which one lacks its bottom tap (four
#: metrics a butterfly); at rates 1/9 and 1/10 the per-edge sums' codes of
#: tests/test_torch_low_rate.py (one polynomial without its bottom tap at
#: K=13 rate 1/10).
LARGE = {(12, 2): (0o4335, 0o5723), (13, 2): (0o10533, 0o17661),
         (14, 2): (0o21645, 0o35661), (15, 2): (0o46321, 0o51271),
         (12, 8): (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163,
                   0o7555),
         (13, 8): (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577,
                   0o16243, 0o17000),
         (14, 8): (0o21645, 0o35661, 0o24567, 0o31235, 0o27771, 0o22223,
                   0o36541, 0o20002),
         (15, 8): (0o46321, 0o51271, 0o63667, 0o70535, 0o41111, 0o57773,
                   0o62345, 0o77776),
         (12, 9): (0o4335, 0o5723, 0o6475, 0o7061, 0o4767, 0o5251, 0o6163,
                   0o7555, 0o4001),
         (13, 9): (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577,
                   0o16243, 0o14101, 0o17017),
         (13, 10): (0o10533, 0o17661, 0o12345, 0o15473, 0o11111, 0o13577,
                    0o16243, 0o14101, 0o17017, 0o10000),
         (15, 9): (0o46321, 0o51271, 0o63667, 0o70535, 0o41111, 0o57773,
                   0o62345, 0o77777, 0o40001)}


@pytest.mark.parametrize("k", range(12, 22))
def test_wide_cluster_sizes(k):
    """C = 2^(k-15) at k = 16-19 (where the H100 holds such a cluster),
    1 elsewhere; the kernels' blocks then own 2^14 states each."""
    tr = make_trellis(k, ((1 << k) - 1, (1 << (k - 1)) + 1))
    want = 1 << (k - 15) if 16 <= k <= 19 else 1
    assert autotune.cluster_size(tr) == want
    held = want > 1 and autotune.H100_CLUSTERS.get(want, 0) > 0
    for unified in (True, False):
        assert autotune.wide_cluster(tr, "cpu", unified=unified) == \
            (want if held else 1)
    if want > 1:
        assert tr.num_states // want == 1 << 14
        assert autotune.cluster_threads(tr, want) == 512


@pytest.mark.parametrize("k", [16, 17, 18, 19])
def test_cluster_block_fits(k):
    """Each block of the cluster holds its double-buffered 8 S / C bytes
    and the core in at most the 227 KB a block may have, on a cluster of
    C and of 2 C; a cluster of C / 2 would not fit."""
    tr = make_trellis(k, CODES[k])
    C = autotune.cluster_size(tr)
    limit = autotune.H100_LIMITS.smem_per_block
    for c in (C, 2 * C):
        total, breakdown = autotune._wide_smem(tr, c)
        assert total == autotune.CLUSTER_CORE_BYTES + 8 * tr.num_states // c
        assert total <= limit and dict(breakdown)["sel_survivors"] == 0
    if C > 2:
        assert autotune._wide_smem(tr, C // 2)[0] > limit
    for unified in (True, False):
        plan = autotune.plan_tiles(tr, autotune.FrameSpec(f=256, v1=20, v2=45),
                                   pack_survivors=True, unified=unified,
                                   device="cpu")
        C_cpu = autotune.wide_cluster(tr, "cpu", unified=unified)
        assert plan.fits and plan.smem_bytes == autotune._wide_smem(
            tr, C_cpu)[0]


@pytest.mark.parametrize("k", [16, 17, 18, 19])
def test_wide_grid_counts_clusters(k):
    """wide_grid gives clusters: at most one a frame, at most the clusters
    the card keeps resident, never more SMs than the card has."""
    tr = make_trellis(k, CODES[k])
    C = autotune.wide_cluster(tr, "cpu")
    for frames in (1, 7, 16, 66, 132, 10_000):
        grid = autotune.wide_grid(tr, frames, "cpu")
        assert 1 <= grid <= frames
        if C > 1:
            assert grid == min(frames, autotune.H100_CLUSTERS[C])
            assert grid * C <= autotune.H100_SMS
        assert autotune.wide_grid(tr, frames, "cpu", cluster=2) == \
            min(frames, autotune.H100_CLUSTERS[2])
    assert autotune.kernel_registers(tr, device="cpu") == \
        autotune.H100_REGISTERS["unified_cluster" if C > 1 else "unified_wide"]


def test_cluster_override_is_checked():
    """The wrappers' private ``_cluster`` takes None, 1 or a power of two;
    anything else is refused before any launch."""
    tr = make_trellis(7, (0o171, 0o133))
    frames = torch.zeros((2, 16 + 8 + 8, 2))
    kw = dict(trellis=tr, v1=8, f=16, v2=8, f0=16, v2s=8, frames_per_tile=1)
    for bad in (0, 3, 6, -2):
        with pytest.raises(ValueError, match="_cluster"):
            vu.unified_decode_frames_cuda(frames, _cluster=bad, **kw)
        with pytest.raises(ValueError, match="_cluster"):
            vf.forward_frames_cuda(frames, trellis=tr, frames_per_tile=1,
                                   _cluster=bad)
    for good in (1, 4, 32):                  # then only the card refuses
        with pytest.raises(ValueError, match="CUDA"):
            vu.unified_decode_frames_cuda(frames, _cluster=good, **kw)


def _parity(x):
    """Parity of each element of a long tensor (31 bits at most)."""
    out = torch.zeros_like(x)
    for i in range(31):
        out ^= (x >> i) & 1
    return out


def _edges(x, trellis, q, bm_dtype):
    """The kernels' branch metrics of butterflies q from one stage's LLRs
    x (F, beta): (F, len(q), 2, 2), [h][p] the edge from 2q + p into
    q + h S/2. Term b of an edge is x[b] with its sign flipped by the
    parity of its encoder word and g_b, summed in b order in float32 and
    rounded once for bf16 (acs.cuh vit_quad); where every polynomial has
    both taps, edges 01 and 10 are edge 00's negation and 11 edge 00
    (vit_edge0)."""
    k, polys = trellis.k, trellis.polys
    e = torch.zeros(x.shape[0], len(q), 2, 2)
    for b, g in enumerate(polys):
        a = _parity((2 * q) & g)
        for h in (0, 1):
            for p in (0, 1):
                flip = a ^ (p & g & 1) ^ (h & (g >> (k - 1)) & 1)
                term = torch.where(flip.bool(), -x[:, b:b + 1], x[:, b:b + 1])
                e[..., h, p] = term if b == 0 else e[..., h, p] + term
    e = e.to(BM_DTYPES[bm_dtype]).float()
    if all(g & 1 and (g >> (k - 1)) & 1 for g in polys):
        e[..., 0, 1] = e[..., 1, 0] = -e[..., 0, 0]
        e[..., 1, 1] = e[..., 0, 0]
    return e


def _cluster_model(llr, trellis, C, bm_dtype, threads=None):
    """VitCluster's recursion in plain torch: per stage, each block c of C
    reads its own old states, runs butterflies [c Hc, (c+1) Hc) and writes
    the new states into the blocks that own them (new state s to block
    s // 2 Hc; on one block, C = 1, q and q + S/2 of its own buffer); the
    stage max and first maximal state from the blocks' partials; each
    block's survivor words (on one block of ``threads`` threads, lane i of
    warp w stores the words of butterflies w 32 + threads i, ...).
    Returns (sel (F, L, S) bool, words (F, L, W) int64, amax (F, L), the
    final normalised path metrics (F, S))."""
    F, L, _ = llr.shape
    S = trellis.num_states
    H, Hc = S // 2, S // 2 // C
    SC = 2 * Hc
    W = packed_width(S)
    buf = [[torch.zeros(F, SC) for _ in range(C)] for _ in range(2)]
    m = torch.zeros(F)
    sels, words, amaxs = [], [], []
    for t in range(L):
        old, new = buf[(t + 1) & 1], buf[t & 1]
        written = torch.zeros(C, SC, dtype=torch.long)
        sel = torch.zeros(F, S, dtype=torch.bool)
        word = torch.zeros(F, W, dtype=torch.long)
        word_hits = torch.zeros(W, dtype=torch.long)
        vals, hits = [], []
        for c in range(C):
            j = torch.arange(Hc)
            q = c * Hc + j
            pp = old[c].view(F, Hc, 2)                 # own states 2q, 2q+1
            p0, p1 = pp[..., 0] - m[:, None], pp[..., 1] - m[:, None]
            e = _edges(llr[:, t], trellis, q, bm_dtype)
            out = []
            for h in (0, 1):
                c0, c1 = p0 + e[..., h, 0], p1 + e[..., h, 1]
                sl = c1 >= c0
                out.append((torch.where(sl, c1, c0), sl))
            (vl, sl), (vh, sh) = out
            for s, v in ((q, vl), (q + H, vh)):        # to the owners
                for dst in range(C):
                    mine = s // SC == dst
                    new[dst][:, s[mine] % SC] = v[:, mine]
                    written[dst, s[mine] % SC] += 1
            sel[:, q], sel[:, q + H] = sl, sh
            # survivor words: whole words of 32 butterflies (one block: the
            # runs its warps' lanes hold), or a small block's partial word
            # ORed into block 0's staging
            runs = (range(0, Hc, 32) if threads is None else
                    [w * 32 + threads * i for w in range(threads // 32)
                     for i in range(Hc // threads)])
            for base, bits in ((c * Hc, sl), (c * Hc + H, sh)):
                for w0 in runs:
                    chunk = bits[:, w0:w0 + 32].long()
                    ballot = (chunk << torch.arange(chunk.shape[1])).sum(1)
                    s0 = base + w0
                    word[:, s0 >> 5] |= ballot << (s0 & 31)
                    word_hits[s0 >> 5] += 1
            vals.append(torch.maximum(vl.max(1).values, vh.max(1).values))
            hits.append((vl, q, vh, q + H))
        assert torch.equal(written, torch.ones_like(written))   # a partition
        assert bool((word_hits >= 1).all())
        if Hc >= 32:                           # whole words, each once
            assert torch.equal(word_hits, torch.ones_like(word_hits))
        m = torch.stack(vals, 1).max(1).values
        first = torch.full((F,), S, dtype=torch.long)
        for vl, ql, vh, qh in hits:            # each block's first hit
            big = torch.full_like(vl, S, dtype=torch.long)
            a_lo = torch.where(vl == m[:, None], ql, big).min(1).values
            a_hi = torch.where(vh == m[:, None], qh, big).min(1).values
            first = torch.minimum(first, torch.minimum(a_lo, a_hi))
        sels.append(sel)
        words.append(word)
        amaxs.append(first)
    v = torch.cat(buf[(L - 1) & 1], 1)
    return (torch.stack(sels, 1), torch.stack(words, 1),
            torch.stack(amaxs, 1), v - m[:, None])


@pytest.mark.parametrize("bm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("k", [8, 9, 10])
def test_ownership_model_equals_plain_recursion(k, C, bm_dtype):
    """The cluster's ownership map, run through 12 stages of 3 noisy
    frames, is a partition of the states and of the survivor words, and
    its selectors, packed words, first maxima and final path metrics equal
    acs_scan's."""
    tr = make_trellis(k, CODES[k])
    rng = np.random.default_rng(100 * k + C)
    F, L = 3, 12
    llr = torch.from_numpy(
        (1.0 - 2.0 * rng.integers(0, 2, (F, L, tr.beta))
         + 0.8 * rng.standard_normal((F, L, tr.beta))).astype(np.float32))
    sels, amaxs = [], []

    def store(t, sel, sigma):
        sels.append(sel)
        amaxs.append(torch.argmax(sigma, dim=1))

    sigma = acs_scan(llr, trellis=tr, L=L, radix=2, store=store,
                     bm_dtype=bm_dtype)
    sel, words, amax, pm = _cluster_model(llr, tr, C, bm_dtype)
    want_sel = torch.stack(sels, 1)
    assert torch.equal(sel, want_sel)
    packed = pack_bits(want_sel).long() & 0xFFFFFFFF
    assert torch.equal(words, packed)
    assert torch.equal(amax, torch.stack(amaxs, 1))
    assert torch.equal(pm, sigma)


def _plain(llr, tr, bm_dtype):
    sels, amaxs = [], []

    def store(t, sel, sigma):
        sels.append(sel)
        amaxs.append(torch.argmax(sigma, dim=1))

    sigma = acs_scan(llr, trellis=tr, L=llr.shape[1], radix=2, store=store,
                     bm_dtype=bm_dtype)
    return torch.stack(sels, 1), torch.stack(amaxs, 1), sigma


@pytest.mark.parametrize("bm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", sorted(LARGE), ids=lambda c: f"k{c[0]}b{c[1]}")
def test_one_block_model_equals_plain_recursion(code, bm_dtype):
    """The one-block form (C = 1, ``large_threads`` threads) of the large
    codes, run through 6 stages of 2 noisy frames: its exchange into its
    own buffer is a partition of the states, its warps' survivor words of
    the words, and its selectors, packed words, first maxima and final path
    metrics equal acs_scan's, branch metrics from the butterfly table
    (per-edge sums past beta = 8, the same four metrics)."""
    tr = make_trellis(code[0], LARGE[code])
    assert autotune.smem_mapping(tr)
    T = autotune.large_threads(tr)
    assert T % 32 == 0 and tr.num_states // 2 // T in (1, 2, 4, 8, 16)
    rng = np.random.default_rng(code[0] * 10 + code[1])
    F, L = 2, 6
    llr = torch.from_numpy(
        (1.0 - 2.0 * rng.integers(0, 2, (F, L, tr.beta))
         + 0.8 * rng.standard_normal((F, L, tr.beta))).astype(np.float32))
    want_sel, want_amax, sigma = _plain(llr, tr, bm_dtype)
    sel, words, amax, pm = _cluster_model(llr, tr, 1, bm_dtype, threads=T)
    assert torch.equal(sel, want_sel)
    assert torch.equal(words, pack_bits(want_sel).long() & 0xFFFFFFFF)
    assert torch.equal(amax, want_amax)
    assert torch.equal(pm, sigma)


@pytest.mark.parametrize("bm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", [(k, len(p)) for k, p in CODES.items()
                                  if k < 16] + sorted(LARGE),
                         ids=lambda c: f"k{c[0]}b{c[1]}")
def test_butterfly_table_equals_compressed_table(code, bm_dtype):
    """Every butterfly's four table metrics (``_edges``, as acs.cuh's
    vit_quad and vit_edge0 build them) equal the plain version's
    ``sgn * bm_half[idx]`` of the same edges, bit for bit, over a few
    noisy stages."""
    k, beta = code
    tr = make_trellis(k, LARGE[code] if code in LARGE else CODES[k])
    H = tr.num_states // 2
    _, idx_p, sgn_p, signs_half = kernel_tables(tr)
    idx = torch.as_tensor(np.stack(idx_p), dtype=torch.long)
    sgn = torch.as_tensor(np.stack(sgn_p), dtype=torch.float32)
    rng = np.random.default_rng(7 * k + beta)
    x = torch.from_numpy((1.0 - 2.0 * rng.integers(0, 2, (4, beta))
                          + 0.8 * rng.standard_normal((4, beta)))
                         .astype(np.float32))
    bm = signed_sum(x, signs_half).to(BM_DTYPES[bm_dtype]).float()
    q = torch.arange(H)
    e = _edges(x, tr, q, bm_dtype)
    for h in (0, 1):
        for p in (0, 1):
            s = q + h * H
            want = sgn[p, s] * bm[:, idx[p, s]]
            got = e[..., h, p]
            # equal as values, zeros of either sign alike
            assert torch.equal(got, want), (h, p)
