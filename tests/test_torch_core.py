"""Parity of the port's core modules (repro_torch.core, packing, tables,
block policy, channel) with the JAX package, on the CPU.

Every test makes its inputs with numpy from a seed and hands the same
arrays to the JAX function and to its port. Integer and float outputs must
be equal bit for bit (tolerance 0); only the channel's random numbers
differ between the packages, and those are held statistically.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel import sim as jsim
from repro.core import decoder as jdec
from repro.core import encoder as jenc
from repro.core import framed as jframed
from repro.core import metrics as jmet
from repro.core import sanitize as jsan
from repro.core import traceback as jtb
from repro.core.trellis import make_trellis as jmake_trellis
from repro.kernels import block as jblock
from repro.kernels import packing as jpack
from repro.kernels import tables as jtables

from repro_torch.channel import sim as tsim
from repro_torch.core import decoder as tdec
from repro_torch.core import encoder as tenc
from repro_torch.core import framed as tframed
from repro_torch.core import metrics as tmet
from repro_torch.core import sanitize as tsan
from repro_torch.core import traceback as ttb
from repro_torch.core.trellis import make_trellis as tmake_trellis
from repro_torch.kernels import block as tblock
from repro_torch.kernels import packing as tpack
from repro_torch.kernels import tables as ttables

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

# the packages' core/__init__ re-export a function named ``puncture``
jpun = importlib.import_module("repro.core.puncture")
tpun = importlib.import_module("repro_torch.core.puncture")

CODES = [(4, (0o13, 0o15, 0o17)),          # beta = 3
         (5, (0o23, 0o35)),
         (7, (0o171, 0o133)),
         (9, (0o753, 0o561))]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _eq(got, want):
    """Bit-for-bit equality (float NaN-free)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _llr(rng, n, beta, scale=1.5):
    return (scale * rng.standard_normal((n, beta))).astype(np.float32)


def _noisy(rng, k, polys, n, snr=3.0):
    """LLRs of a random codeword (numpy encoder), bits and llr (n, beta)."""
    tr = tmake_trellis(k, polys)
    bits = rng.integers(0, 2, n)
    coded = tenc.encode_bits(bits, tr)
    sigma = 10.0 ** (-snr / 20.0)
    llr = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape))
    return bits, llr.astype(np.float32)


@pytest.mark.parametrize("k,polys", CODES)
def test_trellis_tables_equal(k, polys):
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    for name in ("next_state", "out_bits", "prev_state", "prev_out",
                 "branch_input", "bm_index", "bm_sign", "out_signs"):
        _eq(getattr(t, name), getattr(j, name))
    assert (t.k, t.beta, t.polys, t.num_states) == \
        (j.k, j.beta, j.polys, j.num_states)


@pytest.mark.parametrize("k,polys", CODES)
def test_kernel_tables_equal(k, polys):
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    jt, tt = jtables.radix4_tables(j), ttables.radix4_tables(t)
    for p in (0, 1):
        _eq(tt[0][p], jt[0][p])                           # butterfly perm
        for st in (0, 1):
            _eq(tt[1][st][p], jt[1][st][p])               # fused BM index
            _eq(tt[2][st][p], jt[2][st][p])               # BM sign
    _eq(tt[3], jt[3])                                     # signs_half
    jk, tk = jtables.kernel_tables(j), ttables.kernel_tables(t)
    for a, b in zip(tk[:3], jk[:3]):
        for p in (0, 1):
            _eq(a[p], b[p])


@pytest.mark.parametrize("k,polys", CODES)
@pytest.mark.parametrize("init_state", [0, 5])
def test_encoder_equal(k, polys, init_state):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, 300)
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    init_state %= t.num_states
    want = jenc.encode(jnp.asarray(bits), j, init_state)
    _eq(tenc.encode(torch.from_numpy(bits), t, init_state), want)
    if init_state == 0:
        _eq(tenc.encode_bits(bits, t), jenc.encode_bits(bits, j))


@pytest.mark.parametrize("k,polys", CODES)
def test_branch_metrics_equal(k, polys):
    """beta=3 sums three terms, so the order of the additions shows."""
    rng = np.random.default_rng(1)
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    llr = _llr(rng, 257, t.beta, scale=3.7)
    half_j = jmet.branch_metrics_half(jnp.asarray(llr), j)
    half_t = tmet.branch_metrics_half(torch.from_numpy(llr), t)
    _eq(half_t, half_j)
    _eq(tmet.branch_metrics_full(torch.from_numpy(llr), t),
        jmet.branch_metrics_full(jnp.asarray(llr), j))
    _eq(tmet.expand_half(half_t, t), jmet.expand_half(half_j, j))


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4"])
def test_puncture_depuncture_equal(rate):
    rng = np.random.default_rng(2)
    n = 300
    coded = rng.standard_normal((n, 2)).astype(np.float32)
    jp = jpun.puncture(jnp.asarray(coded), rate)
    tp = tpun.puncture(torch.from_numpy(coded), rate)
    _eq(tp, jp)
    _eq(tpun.depuncture(tp, rate, n), jpun.depuncture(jp, rate, n))
    assert tpun.punctured_rate(rate) == jpun.punctured_rate(rate)
    for name in jpun.PATTERNS:
        _eq(tpun.PATTERNS[name], jpun.PATTERNS[name])


def test_check_alignment_equal():
    for args in [(256, 20, 20, "3/4"), (252, 21, 45, "3/4"),
                 (256, 20, 45, "2/3"), (256, 20, 46, "2/3")]:
        outcomes = []
        for fn in (jpun.check_alignment, tpun.check_alignment):
            try:
                fn(*args)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], args


@pytest.mark.parametrize("policy", ["zero", "raise", "off"])
def test_sanitize_equal(policy):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(200).astype(np.float32) * 10
    x[[3, 50, 77]] = [np.nan, np.inf, -np.inf]
    x[[5, 9]] = [3e6, -2e7]
    assert tsan.LLR_CLIP == jsan.LLR_CLIP
    for arr in (x, np.abs(x[np.isfinite(x)]) % 5):
        try:
            want = jsan.sanitize_llr(arr, policy=policy)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(" ")[0]):
                tsan.sanitize_llr(arr, policy=policy)
            continue
        got = tsan.sanitize_llr(arr, policy=policy)
        assert got[1] == want[1]
        _eq(got[0], want[0])


@pytest.mark.parametrize("k,polys", [CODES[0], CODES[2]])
@pytest.mark.parametrize("radix,renorm", [(2, 1), (4, 1), (2, 0), (2, 3)])
def test_viterbi_forward_equal(k, polys, radix, renorm):
    """sel, sigma and amax equal bit for bit (odd n exercises the radix-4
    tail; renorm 0 lets the metrics grow)."""
    rng = np.random.default_rng(4)
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    _, llr = _noisy(rng, k, polys, 161)
    sel_j, sig_j, am_j = jdec.viterbi_forward(jnp.asarray(llr), j,
                                              radix=radix,
                                              renorm_every=renorm)
    sel_t, sig_t, am_t = tdec.viterbi_forward(torch.from_numpy(llr), t,
                                              radix=radix,
                                              renorm_every=renorm)
    _eq(sel_t, sel_j)
    _eq(sig_t, sig_j)
    _eq(am_t, am_j)


@pytest.mark.parametrize("k,polys", CODES)
def test_viterbi_decode_and_traceback_equal(k, polys):
    rng = np.random.default_rng(5)
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    bits, llr = _noisy(rng, k, polys, 200, snr=4.0)
    _eq(tdec.viterbi_decode(torch.from_numpy(llr), t),
        jdec.viterbi_decode(jnp.asarray(llr), j))
    sel, _, am = jdec.viterbi_forward(jnp.asarray(llr), j)
    start = int(am[-1])
    wb, ws = jdec.viterbi_traceback(sel, j, jnp.int32(start))
    tb, ts = tdec.viterbi_traceback(torch.from_numpy(np.array(sel)), t,
                                    torch.tensor(start))
    _eq(tb, wb)
    _eq(ts, ws)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["serial", "boundary", "fixed"])
def test_tracebacks_equal(packed, mode):
    rng = np.random.default_rng(6)
    k, polys = CODES[2]
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    v1, f, v2, f0, v2s = 12, 64, 24, 16, 20
    _, llr = _noisy(rng, k, polys, v1 + f + v2)
    sel, sigma, amax = jdec.viterbi_forward(jnp.asarray(llr), j)
    sel_in = jpack.pack_bits(sel) if packed else sel
    sel_t = torch.from_numpy(np.array(sel_in))
    if mode == "serial":
        start = jnp.argmax(sigma).astype(jnp.int32)
        want = jtb.serial_traceback(sel_in, j, start, v1, f, packed=packed)
        got = ttb.serial_traceback(sel_t, t, torch.tensor(int(start)), v1, f,
                                   packed=packed)
    else:
        want = jtb.parallel_traceback(sel_in, amax, j, v1, f, f0, v2s,
                                      start=mode, packed=packed)
        got = ttb.parallel_traceback(sel_t, torch.from_numpy(np.array(amax)),
                                     t, v1, f, f0, v2s, start=mode,
                                     packed=packed)
    _eq(got, want)


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("n", [8, 32, 64, 100])
def test_packing_equal(layout, n):
    """Bit 31 lands in the int32 sign bit; S < 32 pads one word."""
    rng = np.random.default_rng(n)
    shape = (5, n) if layout == "lane" else (3, n, 7)
    sel = rng.integers(0, 2, shape).astype(np.int8)
    if layout == "lane":
        sel[:, min(31, n - 1)] = 1
    want = jpack.pack_bits(jnp.asarray(sel), jpack.Layout(layout))
    got = tpack.pack_bits(torch.from_numpy(sel), tpack.Layout(layout))
    _eq(got, want)
    _eq(tpack.unpack_bits(got, n, layout), jpack.unpack_bits(want, n, layout))
    if layout == "lane":
        states = rng.integers(0, n, 5).astype(np.int32)
        _eq(tpack.extract_bit(got, torch.from_numpy(states)),
            jpack.extract_bit(want, jnp.asarray(states)))
    else:
        states = rng.integers(0, n, (3, 7)).astype(np.int32)
        _eq(tpack.extract_bit(got, torch.from_numpy(states), layout),
            jpack.extract_bit(want, jnp.asarray(states), layout))
    assert tpack.packed_width(n) == jpack.packed_width(n)


@pytest.mark.parametrize("spec", [
    tframed.FrameSpec(f=64, v1=20, v2=20),
    tframed.FrameSpec(f=48, v1=0, v2=30, f0=16, v2s=20),
])
def test_frame_llr_and_framed_decode_equal(spec):
    rng = np.random.default_rng(7)
    k, polys = CODES[2]
    j, t = jmake_trellis(k, polys), tmake_trellis(k, polys)
    _, llr = _noisy(rng, k, polys, 203)
    jspec = jframed.FrameSpec(**vars(spec))
    _eq(tframed.frame_llr(torch.from_numpy(llr), spec),
        jframed.frame_llr(jnp.asarray(llr), jspec))
    _eq(tframed.framed_decode(torch.from_numpy(llr), t, spec),
        jframed.framed_decode(jnp.asarray(llr), j, jspec))


@pytest.mark.parametrize("B,ov", [(2, 8), (4, 20), (4, 40)])
def test_reframe_and_merge_blocks_equal(B, ov):
    rng = np.random.default_rng(8)
    spec = dict(f=64, v1=20, v2=24)
    frames = rng.standard_normal((3, 108, 2)).astype(np.float32)
    want = jframed.reframe_blocks(jnp.asarray(frames),
                                  jframed.FrameSpec(**spec), B, ov)
    got = tframed.reframe_blocks(torch.from_numpy(frames),
                                 tframed.FrameSpec(**spec), B, ov)
    _eq(got, want)
    bits = rng.integers(0, 2, (3 * B, 64 // B)).astype(np.int32)
    _eq(tframed.merge_blocks(torch.from_numpy(bits), B),
        jframed.merge_blocks(jnp.asarray(bits), B))


def test_blocked_spec_and_block_policy_equal():
    specs = [dict(f=4096, v1=32, v2=32), dict(f=2048, v1=20, v2=45, f0=32,
                                              v2s=45),
             dict(f=256, v1=20, v2=20), dict(f=96, v1=12, v2=24, f0=24,
                                             v2s=20)]
    for k, polys in CODES:
        jt, tt = jmake_trellis(k, polys), tmake_trellis(k, polys)
        for sp in specs:
            js, ts = jframed.FrameSpec(**sp), tframed.FrameSpec(**sp)
            assert tblock.default_overlap(tt, ts) == \
                jblock.default_overlap(jt, js)
            for ov in (0, 8, 35, 64):
                assert tblock.choose_block_frames(ts, ov) == \
                    jblock.choose_block_frames(js, ov)
            for bf, ov in [("auto", None), (4, None), (2, 8), (3, 8),
                           (8, 64), (1, None)]:
                outcomes = []
                for mod, s, tr in ((jblock, js, jt), (tblock, ts, tt)):
                    try:
                        outcomes.append(mod.resolve_block(tr, s, bf, ov))
                        if outcomes[-1][0] > 1:
                            outcomes.append(vars(s.blocked(*outcomes[-1])))
                        outcomes.append(mod.full_overlap(s, 4))
                    except ValueError as e:
                        outcomes.append(str(e))
                half = len(outcomes) // 2
                assert outcomes[:half] == outcomes[half:], (sp, bf, ov)


def test_theory_equal():
    grid = np.array([1.0, 2.0, 2.5, 3.0, 4.0])
    _eq(tsim.theoretical_ber(grid), jsim.theoretical_ber(grid))
    meas = jsim.theoretical_ber(grid - 0.4)
    assert tsim.ebn0_distance_metric(grid, meas) == \
        jsim.ebn0_distance_metric(grid, meas)
    x = torch.tensor([0, 1, 1, 0])
    _eq(tsim.bpsk(x), jsim.bpsk(jnp.asarray(x.numpy())))
    assert tsim.ber(x, torch.tensor([0, 1, 0, 0])) == 0.25


def test_awgn_statistics():
    """The torch generator draws other numbers than jax.random: hold the
    noise to its distribution. 2e5 samples: the mean's standard error is
    sigma/447, the std's about sigma/632, the sign-flip rate's
    sqrt(p(1-p)/2e5); each tolerance is 5 standard errors."""
    from scipy.stats import norm
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = tsim.awgn(x, 3.0, g)
    sigma = 10.0 ** (-3.0 / 20.0)
    assert abs(float(y.mean()) - 1.0) < 5 * sigma / 447
    assert abs(float(y.std()) - sigma) < 5 * sigma / 632
    p = norm.sf(1.0 / sigma)                  # hard-decision error rate
    flips = float((y < 0).to(torch.float32).mean())
    assert abs(flips - p) < 5 * np.sqrt(p * (1 - p) / 2e5), (flips, p)
    g2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(tsim.awgn(x, 3.0, g2), y, rtol=0, atol=0)


def test_simulate_ber_matches_jax_statistically():
    """tests/test_ber.py's tolerances, for the framed (f=256, v1=v2=20)
    decoder: at 2 dB the BER lies between the union bound / 30 and the
    union bound (test_full_decoder_tracks_theory), it falls from 2 to 3 dB,
    and the port's BER is within 0.3*max + 2e-4 of the JAX package's on
    its own channel (test_v2_dominates_ber's tolerance for decoders of
    equal strength). At 3 dB the bound is tight and a framed decoder's
    error bursts scatter around it, so its upper half is held at 2 dB
    only. N = 4e5 bits (~2000 errors at 2 dB) keeps the bursty spread
    well inside the tolerance."""
    N = 400_000
    spec = tframed.FrameSpec(256, 20, 20)
    jspec = jframed.FrameSpec(256, 20, 20)
    k, polys = CODES[2]
    t, j = tmake_trellis(k, polys), jmake_trellis(k, polys)
    theo = tsim.theoretical_ber(np.array([2.0, 3.0]))
    meas = []
    for e in (2.0, 3.0):
        g = torch.Generator().manual_seed(1)
        b, bits, dec = tsim.simulate(
            g, N, e, lambda l: tframed.framed_decode(l, t, spec))
        assert dec.shape == bits.shape == (N,)
        meas.append(b)
    assert theo[0] / 30 < meas[0] < theo[0], (meas[0], theo[0])
    assert meas[0] > meas[1] > 0
    bj, _, _ = jsim.simulate(jax.random.PRNGKey(1), N, 2.0,
                             lambda l: jframed.framed_decode(l, j, jspec))
    assert abs(meas[0] - bj) < 0.3 * max(meas[0], bj) + 2e-4, (meas[0], bj)
