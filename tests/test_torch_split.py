"""The port's split path against the JAX package's, on the CPU.

The split path is the prior-work baseline: the forward kernel streams
survivors and per-stage argmax to device memory, and a traceback reads
them back. On the CPU the port runs the forward kernel's plain version
(``viterbi_fwd.forward_frames_plain``) and the traceback kernel's
(``core.traceback.*_frames``). The same numpy inputs go through the JAX
functions (the Pallas kernel in interpret mode, as the JAX tests run it)
and their port counterparts. Tolerance: exact (``np.array_equal``, and
equal dtypes and shapes) throughout.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.viterbi_fwd import forward_frames as jforward_frames

from repro_torch.core import pipeline as tpipe
from repro_torch.core import traceback as ttb
from repro_torch.core.encoder import encode_bits
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import ops, ref
from repro_torch.kernels import traceback_frames as tbf
from repro_torch.kernels import viterbi_fwd as vf

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

K7 = (7, (0o171, 0o133))
K5 = (5, (0o23, 0o35))
K4B3 = (4, (0o13, 0o15, 0o17))
_cache = {}


def _llr(code, n, seed, snr=3.0):
    """Noisy LLRs (n, beta) of a random codeword, made with numpy."""
    rng = np.random.default_rng(seed)
    coded = encode_bits(rng.integers(0, 2, n), make_trellis(*code))
    sigma = 10.0 ** (-snr / 20.0)
    llr = 1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)
    return llr.astype(np.float32)


def _frames(code, spec, n, seed, snr=3.0):
    """The same frames for both packages: (numpy frames, torch, jax)."""
    llr = _llr(code, n, seed, snr)
    t = frame_llr(torch.from_numpy(llr), spec)
    return t.numpy(), t, jframe_llr(jnp.asarray(llr), JFrameSpec(**vars(spec)))


def _jax_forward(code, x, **knobs):
    """JAX forward_frames (Pallas, interpret mode), cached per input/knobs."""
    key = ("fwd", code, x.shape, x.tobytes(), tuple(sorted(knobs.items())))
    if key not in _cache:
        sel, amax = jforward_frames(jnp.asarray(x),
                                    trellis=jmake_trellis(*code), **knobs)
        _cache[key] = (np.asarray(sel), np.asarray(amax))
    return _cache[key]


def _jax_ref_bits(code, spec, n, seed, snr=3.0):
    key = ("ref", code, spec, n, seed, snr)
    if key not in _cache:
        _, _, jf = _frames(code, spec, n, seed, snr)
        _cache[key] = np.asarray(jref.unified_decode_frames_ref(
            jf, jmake_trellis(*code), JFrameSpec(**vars(spec))))
    return _cache[key]


def _assert_same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


FWD_SPEC = FrameSpec(f=64, v1=16, v2=21)          # L = 101, odd: radix tail


@pytest.mark.parametrize("bm", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
def test_forward_kernel_knobs_match_jax(radix, pack, layout, bm):
    """sel and amax equal JAX's forward_frames element for element, in
    shape, dtype and orientation, for every knob (K=7)."""
    x, t, _ = _frames(K7, FWD_SPEC, 64 * 8, 0)
    knobs = dict(pack_survivors=pack, radix=radix, layout=layout,
                 bm_dtype=bm, frames_per_tile=8)
    sel, amax = _jax_forward(K7, x, **knobs)
    got_sel, got_amax = vf.forward_frames(t, trellis=make_trellis(*K7),
                                          **knobs)
    _assert_same(got_sel, sel)
    _assert_same(got_amax, amax)


@pytest.mark.parametrize("code", [K4B3, K5])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("bm", ["float32", "bfloat16"])
def test_forward_kernel_other_codes_match_jax(code, layout, pack, bm):
    """beta=3 (branch metric summed in b order) and S < 32 (one
    zero-padded word); a tile of 3 frames, not a power of two."""
    x, t, _ = _frames(code, FWD_SPEC, 64 * 6, 1, snr=5.0)
    radix = 4 if pack else 2
    knobs = dict(pack_survivors=pack, radix=radix, layout=layout,
                 bm_dtype=bm, frames_per_tile=3)
    sel, amax = _jax_forward(code, x, **knobs)
    got_sel, got_amax = vf.forward_frames(t, trellis=make_trellis(*code),
                                          **knobs)
    _assert_same(got_sel, sel)
    _assert_same(got_amax, amax)


def test_forward_kernel_matches_ref():
    """Mirrors tests/test_kernels.py::test_forward_kernel_matches_ref: the
    plain version == the port's ref == JAX's ref."""
    x, t, jf = _frames(K7, FWD_SPEC, 500, 2)
    tr = make_trellis(*K7)
    sel, amax = vf.forward_frames_plain(t, trellis=tr, frames_per_tile=1)
    rsel, ramax = ref.forward_frames_ref(t, tr)
    jsel, jamax = jref.forward_frames_ref(jf, jmake_trellis(*K7))
    assert torch.equal(sel, rsel) and torch.equal(amax, ramax)
    _assert_same(sel, np.asarray(jsel))
    _assert_same(amax, np.asarray(jamax))


def test_forward_kernel_packed_stream():
    """Mirrors test_kernels.py::test_forward_kernel_packed_stream."""
    from repro.kernels.packing import pack_bits as jpack_bits
    x, t, jf = _frames(K7, FWD_SPEC, 500, 2)
    sel, amax = vf.forward_frames(t, trellis=make_trellis(*K7),
                                  pack_survivors=True, frames_per_tile=1)
    jsel, jamax = jref.forward_frames_ref(jf, jmake_trellis(*K7))
    assert tuple(sel.shape) == (x.shape[0], FWD_SPEC.frame_len, 2)
    _assert_same(sel, np.asarray(jpack_bits(jsel)))
    _assert_same(amax, np.asarray(jamax))


@pytest.mark.parametrize("code", [(3, (0o7, 0o5)), (6, (0o65, 0o57)),
                                  (11, (0o3345, 0o3613))])
def test_forward_kernel_edge_codes_match_jax(code):
    """The forward kernel's plain version equals JAX's oracle on the codes
    at the edges of the CUDA kernels' lane mapping (S=4, 32, 1024): sel
    unpacked and packed (both layouts) and the per-stage argmax."""
    from repro.kernels.packing import pack_bits as jpack_bits
    spec = FrameSpec(f=32, v1=12, v2=17)            # L = 61, odd
    x, t, jf = _frames(code, spec, 32 * 3, 8, snr=5.0)
    tr = make_trellis(*code)
    jsel, jamax = jref.forward_frames_ref(jf, jmake_trellis(*code))
    sel, amax = vf.forward_frames(t, trellis=tr, frames_per_tile=3)
    _assert_same(sel, np.asarray(jsel))
    _assert_same(amax, np.asarray(jamax))
    packed = np.asarray(jpack_bits(jsel))                  # (F, L, W)
    for layout, want in (("lane", packed),
                         ("sublane", packed.transpose(1, 2, 0)
                          .reshape(-1, packed.shape[0]))):
        sel, amax = vf.forward_frames(t, trellis=tr, pack_survivors=True,
                                      radix=4, layout=layout,
                                      frames_per_tile=3)
        _assert_same(sel, np.ascontiguousarray(want))
        _assert_same(amax, np.asarray(jamax))


#: Codes past the register mapping (one block a frame on the card): K=12,
#: K=13 and the Galileo (15, 1/4) code.
LARGE_CODES = [(12, (0o4335, 0o5723)), (13, (0o10533, 0o17661)),
               (15, (0o46321, 0o51271, 0o63667, 0o70535))]
LARGE_SPEC = FrameSpec(f=32, v1=12, v2=17)          # L = 61, odd


def _jax_ref_streams(code, jf, layout, pack):
    """JAX's oracle stream (forward_frames_ref), packed and laid out as
    the forward kernel writes it."""
    from repro.kernels.packing import pack_bits as jpack_bits
    jsel, jamax = jref.forward_frames_ref(jf, jmake_trellis(*code))
    jsel = np.asarray(jsel)
    if pack:
        jsel = np.asarray(jpack_bits(jnp.asarray(jsel)))   # (F, L, W)
    if layout == "sublane":
        F = jsel.shape[0]
        jsel = np.ascontiguousarray(jsel.transpose(1, 2, 0))
        if pack:
            jsel = jsel.reshape(-1, F)
    return jsel, np.asarray(jamax)


@pytest.mark.parametrize("code", LARGE_CODES)
def test_forward_kernel_large_codes_match_jax(code):
    """The forward kernel's plain version equals JAX's oracle at k = 12,
    13, 15: sel unpacked and packed in both layouts, radix 2 and 4, and
    the per-stage argmax."""
    _, t, jf = _frames(code, LARGE_SPEC, 32 * 3, 13, snr=5.0)
    tr = make_trellis(*code)
    for layout in ("lane", "sublane"):
        for pack, radix in ((False, 2), (True, 4)):
            want_sel, want_amax = _jax_ref_streams(code, jf, layout, pack)
            sel, amax = vf.forward_frames(t, trellis=tr, pack_survivors=pack,
                                          radix=radix, layout=layout,
                                          frames_per_tile=1)
            _assert_same(sel, want_sel)
            _assert_same(amax, want_amax)


@pytest.mark.parametrize("code", LARGE_CODES)
@pytest.mark.parametrize("chase", ["serial", "boundary", "fixed"])
def test_traceback_frames_large_codes_match_jax(code, chase):
    """serial/parallel_traceback_frames and the traceback kernel's plain
    version equal JAX's at k = 12, 13, 15, over layout x pack."""
    _, t, jf = _frames(code, LARGE_SPEC, 32 * 3, 14, snr=5.0)
    jtr, tr = jmake_trellis(*code), make_trellis(*code)
    v1, f = LARGE_SPEC.v1, LARGE_SPEC.f
    f0, v2s, start = {"serial": (32, LARGE_SPEC.v2, "boundary"),
                      "boundary": (8, 17, "boundary"),
                      "fixed": (16, 9, "fixed")}[chase]
    for layout in ("lane", "sublane"):
        for pack in (False, True):
            jsel, jamax = _jax_ref_streams(code, jf, layout, pack)
            tsel, tamax = vf.forward_frames(t, trellis=tr,
                                            pack_survivors=pack,
                                            layout=layout, frames_per_tile=1)
            if chase == "serial":
                want = jtb.serial_traceback_frames(
                    jnp.asarray(jsel), jnp.asarray(jamax), jtr, v1, f,
                    packed=pack, layout=layout)
            else:
                want = jtb.parallel_traceback_frames(
                    jnp.asarray(jsel), jnp.asarray(jamax), jtr, v1, f, f0,
                    v2s, start, packed=pack, layout=layout)
            want = np.asarray(want).astype(np.int32)
            _assert_same(tbf.traceback_frames(
                tsel, tamax, trellis=tr, v1=v1, f=f, f0=f0, v2s=v2s,
                start=start, packed=pack, layout=layout), want)


@pytest.mark.parametrize("code", LARGE_CODES)
def test_split_large_codes_match_jax(code):
    """The split path (plain forward kernel + plain chase) decodes k = 12,
    13, 15 to JAX's oracle bits, packed and not, both layouts."""
    spec = FrameSpec(f=32, v1=12, v2=16, f0=8, v2s=16)
    _, t, _ = _frames(code, spec, 64, 15, snr=6.0)
    want = _jax_ref_bits(code, spec, 64, 15, snr=6.0)
    for pack, radix, layout in [(True, 4, "sublane"), (False, 2, "lane"),
                                (True, 2, "lane"), (False, 4, "sublane")]:
        _assert_same(_split(t, code, spec, pack_survivors=pack, radix=radix,
                            layout=layout, frames_per_tile=1), want)


@pytest.mark.parametrize("backend", ["kernel", "kernel_split"])
def test_make_decoder_large_code_matches_jax(backend):
    """make_decoder with a K=13 rate-1/2 code equals the JAX package's
    make_decoder on the same stream (tests/_torch_parity.jax_decode)."""
    from _torch_parity import jax_decode, rx
    tr = make_trellis(*LARGE_CODES[1])
    spec = FrameSpec(f=64, v1=24, v2=40, f0=16, v2s=40)
    n = 3 * spec.f + 11
    stream = rx(n, seed=16, snr=5.0, trellis=tr)
    cfg = tpipe.DecoderConfig(trellis=tr, spec=spec, backend=backend)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    _assert_same(got, jax_decode(cfg, stream, n).astype(np.int32))


@pytest.mark.parametrize("code,packed,staged", [
    ((3, (0o7, 0o5)), False, (True, True)),
    ((7, (0o171, 0o133)), False, (True, False)),
    ((8, (0o371, 0o247)), False, (True, False)),
    ((9, (0o753, 0o561)), False, (False, False)),
    ((7, (0o171, 0o133)), True, (True, True)),
    ((10, (0o1671, 0o1233)), True, (True, False)),
    ((11, (0o3345, 0o3613)), True, (True, False)),
    ((12, (0o4335, 0o5723)), True, (False, False))])
def test_traceback_chase_rule(code, packed, staged):
    """The traceback kernel's mode rule at the main frame (L=321, 301
    stages chased): staged in shared memory iff a stage row is at most
    STAGE_ROW_BYTES (128) bytes and the smallest group (1 frame lane, 8
    sublane) fits STAGE_BYTES (40 KB); staged blocks take the most frames
    (a power of two, at most MAX_GROUP) within STAGE_BYTES; direct blocks
    the fewest frames that put all blocks on the card at once (16384
    frames over 132 SMs x 32 blocks: 4; 4096 frames: 1)."""
    tr = make_trellis(*code)
    kw = dict(L=321, f=256, f0=32, v2s=45, F=16384, packed=packed)
    for layout, want in zip(("lane", "sublane"), staged):
        plan = tbf.chase_plan(tr, layout=layout, **kw)
        assert plan.staged == want
        if want:
            assert plan.smem_bytes <= tbf.STAGE_BYTES
            assert plan.frames == tbf.MAX_GROUP or tbf._smem_bytes(
                tr.k, 256, 45, 321, packed, layout == "sublane",
                2 * plan.frames, True) > tbf.STAGE_BYTES
        else:
            assert plan.frames == 4
            assert tbf.chase_plan(tr, layout=layout,
                                  **dict(kw, F=4096)).frames == 1
            assert tbf.chase_plan(tr, layout=layout, sms=66,
                                  **dict(kw, F=4096)).frames == 2
        assert plan.threads == max(32, -(-plan.frames * 8 // 32) * 32)


def test_traceback_chase_plan_at_the_main_shape():
    """K=7 packed lane at the main shape: 8 frames of 2568 bytes a block
    (20 KB with the bits), 64 cursors; pinning a mode works, a direct
    block's frames follow the SMs it must cover, and a staged block too
    large for a block's shared memory (one K=12 unpacked frame) raises."""
    tr = make_trellis(*K7)
    kw = dict(L=321, f=256, f0=32, v2s=45, F=16384, packed=True)
    plan = tbf.chase_plan(tr, **kw)
    assert plan == tbf.ChasePlan(True, 8, 64, 16 + 256 + 7 * 2568 +
                                 301 * 8 + 16)
    assert tbf.chase_plan(tr, chase="direct", **kw).staged is False
    assert tbf.chase_plan(tr, chase="direct", sms=11, blocks_per_sm=1,
                          **dict(kw, F=33)).frames == 3
    assert tbf.chase_plan(tr, **dict(kw, F=5)).frames == 8
    assert tbf.chase_plan(tr, **dict(kw, F=3)).frames == 4
    with pytest.raises(ValueError, match="shared memory"):
        tbf.chase_plan(make_trellis(12, (0o4335, 0o5723)), chase="staged",
                       **dict(kw, packed=False))
    with pytest.raises(ValueError, match="chase"):
        tbf.chase_plan(tr, chase="tma", **kw)
    serial = tbf.chase_plan(tr, **dict(kw, f0=256))
    assert serial.staged and serial.frames == 8 and serial.threads == 32
    sub = tbf.chase_plan(tr, layout="sublane", **kw)
    assert sub.staged and sub.frames == 16 and sub.threads == 128


def _streams(code, x, layout, pack):
    """(JAX sel, amax) and (port sel, amax) of the same frames."""
    knobs = dict(pack_survivors=pack, layout=layout, frames_per_tile=8)
    jsel, jamax = _jax_forward(code, x, **knobs)
    tsel, tamax = vf.forward_frames(torch.from_numpy(x),
                                    trellis=make_trellis(*code), **knobs)
    return (jnp.asarray(jsel), jnp.asarray(jamax)), (tsel, tamax)


TB_GEOMETRY = {"serial": (64, None, "boundary"),
               "boundary": (16, 17, "boundary"),
               "fixed": (32, 9, "fixed")}


@pytest.mark.parametrize("chase", list(TB_GEOMETRY))
@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
def test_traceback_frames_match_jax(pack, layout, chase):
    """serial/parallel_traceback_frames == JAX's over layout x pack x
    serial/boundary/fixed, and traceback_frames_plain (the traceback
    kernel's plain version) picks the same chase."""
    x, _, _ = _frames(K7, FWD_SPEC, 64 * 8, 3)
    (jsel, jamax), (tsel, tamax) = _streams(K7, x, layout, pack)
    jtr, tr = jmake_trellis(*K7), make_trellis(*K7)
    v1, f = FWD_SPEC.v1, FWD_SPEC.f
    f0, v2s, start = TB_GEOMETRY[chase]
    if chase == "serial":
        want = jtb.serial_traceback_frames(jsel, jamax, jtr, v1, f,
                                           packed=pack, layout=layout)
        got = ttb.serial_traceback_frames(tsel, tamax, tr, v1, f,
                                          packed=pack, layout=layout)
        v2s = FWD_SPEC.v2
    else:
        want = jtb.parallel_traceback_frames(jsel, jamax, jtr, v1, f, f0,
                                             v2s, start, packed=pack,
                                             layout=layout)
        got = ttb.parallel_traceback_frames(tsel, tamax, tr, v1, f, f0, v2s,
                                            start, packed=pack,
                                            layout=layout)
    want = np.asarray(want).astype(np.int32)
    _assert_same(got, want)
    _assert_same(tbf.traceback_frames(
        tsel, tamax, trellis=tr, v1=v1, f=f, f0=f0, v2s=v2s, start=start,
        packed=pack, layout=layout), want)


@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_traceback_frames_small_code_sliced_stream(layout):
    """K=5 (S=16, one padded word), and a sublane stream sliced to fewer
    frames than it holds, as ops slices the padded stream."""
    x, _, _ = _frames(K5, FWD_SPEC, 64 * 8, 4, snr=5.0)
    for pack in (False, True):
        (jsel, jamax), (tsel, tamax) = _streams(K5, x, layout, pack)
        F = 5
        jsel = jsel[..., :F] if layout == "sublane" else jsel[:F]
        tsel = tsel[..., :F] if layout == "sublane" else tsel[:F]
        want = jtb.parallel_traceback_frames(
            jsel, jamax[:F], jmake_trellis(*K5), 16, 64, 16, 17,
            packed=pack, layout=layout)
        got = tbf.traceback_frames(tsel, tamax[:F], trellis=make_trellis(*K5),
                                   v1=16, f=64, f0=16, v2s=17, packed=pack,
                                   layout=layout)
        _assert_same(got, np.asarray(want).astype(np.int32))


def test_traceback_frames_rejects_bad_streams():
    tr = make_trellis(*K7)
    sel = torch.zeros((4, 101, 2), dtype=torch.int32)
    amax = torch.zeros((4, 101), dtype=torch.int32)
    kw = dict(trellis=tr, v1=16, f=64, f0=16, v2s=17, packed=True)
    with pytest.raises(ValueError, match="sel must be"):
        tbf.traceback_frames(sel, amax, layout="sublane", **kw)
    with pytest.raises(ValueError, match="v2s"):
        tbf.traceback_frames(sel, amax, **dict(kw, v2s=40))
    with pytest.raises(ValueError, match="CUDA device"):
        tbf.traceback_frames_cuda(sel, amax, **kw)
    assert tbf.traceback_frames(sel, amax, **kw).shape == (4, 64)


def _split(t, code, spec, **kw):
    return ops.viterbi_decode_frames(t, make_trellis(*code), spec,
                                     unified=False, device="cpu", **kw)


@pytest.mark.parametrize("spec", [
    FrameSpec(f=64, v1=20, v2=20),
    FrameSpec(f=64, v1=20, v2=20, f0=16, v2s=20),
])
def test_split_kernel_matches_jax(spec):
    """Mirrors test_kernels.py::test_split_kernel_matches_ref."""
    _, t, _ = _frames(K7, spec, 600, 5)
    _assert_same(_split(t, K7, spec), _jax_ref_bits(K7, spec, 600, 5))


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
def test_split_kernel_knobs_match_jax(pack, radix, layout):
    """Mirrors test_kernels.py::test_split_kernel_knobs_match_ref."""
    spec = FrameSpec(f=64, v1=20, v2=20, f0=16, v2s=20)
    _, t, _ = _frames(K7, spec, 600, 6)
    got = _split(t, K7, spec, pack_survivors=pack, radix=radix,
                 layout=layout)
    _assert_same(got, _jax_ref_bits(K7, spec, 600, 6))


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_split_serial_traceback_layouts(unified, layout):
    """Mirrors test_kernels.py::test_split_serial_traceback_layouts."""
    spec = FrameSpec(f=64, v1=16, v2=16)
    _, t, _ = _frames(K7, spec, 400, 7)
    got = ops.viterbi_decode_frames(t, make_trellis(*K7), spec,
                                    unified=unified, layout=layout,
                                    device="cpu")
    _assert_same(got, _jax_ref_bits(K7, spec, 400, 7))


@pytest.mark.parametrize("code", [K4B3, K5])
def test_split_small_state_codes_packed_sublane(code):
    """Mirrors test_kernels.py::test_small_state_codes_packed_sublane."""
    spec = FrameSpec(f=64, v1=16, v2=16, f0=16, v2s=16)
    _, t, _ = _frames(code, spec, 400, 8, snr=6.0)
    got = _split(t, code, spec, pack_survivors=True, radix=4,
                 layout="sublane")
    _assert_same(got, _jax_ref_bits(code, spec, 400, 8, snr=6.0))


@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_split_bf16_branch_metrics_match_jax_kernel(layout):
    """bf16 branch metrics are not the reference's bits: the port's split
    path equals JAX's split path (Pallas, interpret mode) with them."""
    spec = FrameSpec(f=64, v1=20, v2=20, f0=16, v2s=20)
    _, t, jf = _frames(K4B3, spec, 384, 9, snr=2.0)
    want = np.asarray(jops.viterbi_decode_frames(
        jf, jmake_trellis(*K4B3), JFrameSpec(**vars(spec)), unified=False,
        layout=layout, bm_dtype="bfloat16", frames_per_tile=8))
    got = _split(t, K4B3, spec, layout=layout, bm_dtype="bfloat16",
                 frames_per_tile=8)
    _assert_same(got, want)


def test_split_frame_padding_matches_jax():
    """5 frames with a tile of 8 in the sublane layout: padded, streamed,
    sliced back to 5 frames on the trailing axis, traced back."""
    spec = FrameSpec(f=64, v1=16, v2=16, f0=16, v2s=16)
    _, t, _ = _frames(K7, spec, 64 * 5, 10)
    assert t.shape[0] == 5
    for layout in ("lane", "sublane"):
        got = _split(t, K7, spec, frames_per_tile=8, layout=layout)
        _assert_same(got, _jax_ref_bits(K7, spec, 64 * 5, 10))


def test_split_kernel_trace_event():
    from repro_torch.obs import tracer as obs
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        _split(torch.zeros((3, spec.frame_len, 2)), K7, spec)
    finally:
        obs.set_tracer(prev)
    (ev,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
    assert ev.attrs["kernel"] == "split" and ev.attrs["frames"] == 3
    assert ev.attrs["mapping"] == "plain"             # no launch off the card


def test_split_cpu_tensor_never_reaches_the_kernels():
    spec = FrameSpec(f=64, v1=16, v2=16)
    _, t, _ = _frames(K7, spec, 128, 11)
    tr = make_trellis(*K7)
    before = (vf.forward_frames_cuda.launches,
              tbf.traceback_frames_cuda.launches)
    _split(t, K7, spec)
    with pytest.raises(ValueError, match="CUDA device"):
        vf.forward_frames_cuda(t, trellis=tr, frames_per_tile=1)
    assert (vf.forward_frames_cuda.launches,
            tbf.traceback_frames_cuda.launches) == before


RATE_SPECS = {"1/2": FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20),
              "3/4": FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)}


@pytest.mark.parametrize("rate,layout", [("1/2", "lane"), ("1/2", "sublane"),
                                         ("3/4", "lane")])
def test_make_decoder_kernel_split_matches_jax(rate, layout):
    """The whole slice: make_decoder(backend="kernel_split") == the JAX
    package's make_decoder(backend="kernel_split") on the same punctured
    stream."""
    from repro_torch.core.puncture import puncture
    spec = RATE_SPECS[rate]
    n = 8 * spec.f + 5
    rng = np.random.default_rng(12)
    coded = encode_bits(rng.integers(0, 2, n), make_trellis(*K7))
    tx = (1.0 - 2.0 * puncture(torch.from_numpy(np.asarray(coded)),
                               rate).numpy()).astype(np.float32)
    stream = tx + 0.6 * rng.standard_normal(tx.shape).astype(np.float32)
    cfg = tpipe.DecoderConfig(spec=spec, rate=rate, backend="kernel_split",
                              layout=layout)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    jcfg = jpipe.DecoderConfig(spec=JFrameSpec(**vars(spec)), rate=rate,
                               backend="kernel_split", layout=layout)
    want = np.asarray(jpipe.make_decoder(jcfg)(jnp.asarray(stream), n))
    _assert_same(got, want.astype(np.int32))
