"""The cluster mapping of the wide ACS kernels (16 <= k <= 19), on the CPU.

On the card ``csrc/acs.cuh``'s ``VitCluster`` runs one frame on a
thread-block cluster of C blocks that exchange path metrics through
distributed shared memory; ``tests/test_torch_gpu.py`` holds the kernels
to their plain versions there. Here, without a card:

* the planner: C = 2, 4, 8, 16 at k = 16-19 and 1 elsewhere, each block's
  shared memory within the H100's 227 KB, ``wide_grid`` counting
  clusters and never more than the frames;
* a plain torch model of the kernel's ownership map (which block reads and
  writes which states, the block partials of the stage max and of the
  first maximal state, the survivor words each block stores), run through
  a few stages at K=8-10 on clusters of 2, 4 and 8 blocks: every new state
  and every survivor word is written exactly once, and the selectors,
  first maxima and path metrics equal ``acs.py``'s plain recursion (held
  against the JAX package's by test_torch_kernels.py) bit for bit.

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


def _cluster_model(llr, trellis, C, bm_dtype):
    """VitCluster's recursion in plain torch: per stage, each block c of C
    reads its own old states, runs butterflies [c Hc, (c+1) Hc) and writes
    the new states into the blocks that own them; the stage max and first
    maximal state from the blocks' partials; each block's survivor words.
    Returns (sel (F, L, S) bool, words (F, L, W) int64, amax (F, L), the
    final normalised path metrics (F, S))."""
    F, L, _ = llr.shape
    S = trellis.num_states
    H, Hc = S // 2, S // 2 // C
    SC = 2 * Hc
    _, idx_p, sgn_p, signs_half = kernel_tables(trellis)
    idx = torch.as_tensor(np.stack(idx_p), dtype=torch.long)
    sgn = torch.as_tensor(np.stack(sgn_p), dtype=torch.float32)
    bm = signed_sum(llr, signs_half).to(BM_DTYPES[bm_dtype]).float()
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
            out = []
            for h in (0, 1):
                s = q + h * H
                e = [sgn[p, s] * bm[:, t, idx[p, s]] for p in (0, 1)]
                c0, c1 = p0 + e[0], p1 + e[1]
                sl = c1 >= c0
                out.append((torch.where(sl, c1, c0), sl))
            (vl, sl), (vh, sh) = out
            for dst, v in ((c >> 1, vl), ((c >> 1) + C // 2, vh)):
                new[dst][:, (c & 1) * Hc + j] = v
                written[dst, (c & 1) * Hc + j] += 1
            sel[:, q], sel[:, q + H] = sl, sh
            # survivor words: whole words of 32 butterflies, or a small
            # block's partial word ORed into block 0's staging
            for base, bits in ((c * Hc, sl), (c * Hc + H, sh)):
                for w0 in range(0, Hc, 32):
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
