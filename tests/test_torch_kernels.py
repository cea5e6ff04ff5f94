"""Parity of the port's kernel modules with the JAX package, on the CPU.

``repro_torch.kernels.ops.viterbi_decode_frames(..., device="cpu")`` runs
the unified kernel's plain torch version; it must give the same bits as
the JAX package over the knob grid of tests/test_kernels.py. For float32
branch metrics every knob is bit-identical to ``repro.kernels.ref`` (the
JAX tests hold the Pallas kernel equal to it), so the port is compared
with that jitted oracle; for bfloat16 branch metrics it is compared with
the Pallas kernel itself, in interpret mode. Tolerance 0 throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FrameSpec as JFrameSpec
from repro.core.framed import frame_llr as jframe_llr
from repro.core.trellis import make_trellis as jmake_trellis
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.encoder import encode_bits
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.obs import tracer as obs

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

K7 = (7, (0o171, 0o133))
_jref_cache = {}


def _llr(code, n, seed, snr=3.0, dtype=np.float32):
    """Noisy LLRs (n, beta) of a random codeword, made with numpy."""
    rng = np.random.default_rng(seed)
    tr = make_trellis(*code)
    coded = encode_bits(rng.integers(0, 2, n), tr)
    sigma = 10.0 ** (-snr / 20.0)
    llr = 1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)
    return llr.astype(np.float32).astype(dtype)


def _both(code, spec, n, seed, snr=3.0, dtype=np.float32):
    """The same frames for both packages: (torch frames, jax frames)."""
    llr = _llr(code, n, seed, snr, dtype)
    if dtype == np.float32:
        t = frame_llr(torch.from_numpy(llr), spec)
    else:                                     # bfloat16 as torch/jax dtypes
        t = frame_llr(torch.from_numpy(llr.astype(np.float32))
                      .to(torch.bfloat16), spec)
    j = jframe_llr(jnp.asarray(llr), JFrameSpec(**vars(spec)))
    return t, j


def _jax_ref(code, spec, n, seed, snr=3.0):
    """JAX oracle bits, shared by every knob of one input."""
    key = (code, spec, n, seed, snr)
    if key not in _jref_cache:
        _, jf = _both(code, spec, n, seed, snr)
        _jref_cache[key] = np.asarray(jref.unified_decode_frames_ref(
            jf, jmake_trellis(*code), JFrameSpec(**vars(spec))))
    return _jref_cache[key]


def _port(frames, code, spec, **kw):
    return ops.viterbi_decode_frames(frames, make_trellis(*code), spec,
                                     device="cpu", **kw).numpy()


@pytest.mark.parametrize("spec", [
    FrameSpec(f=64, v1=20, v2=20),                      # serial tb
    FrameSpec(f=64, v1=20, v2=20, f0=16, v2s=20),       # parallel tb
    FrameSpec(f=64, v1=20, v2=20, f0=8, v2s=16),
    FrameSpec(f=128, v1=0, v2=32, f0=32, v2s=32),       # no left overlap
    FrameSpec(f=96, v1=12, v2=24, f0=24, v2s=20, start="fixed"),
])
def test_unified_matches_jax(spec):
    tf, _ = _both(K7, spec, 1000, 0)
    np.testing.assert_array_equal(_port(tf, K7, spec),
                                  _jax_ref(K7, spec, 1000, 0))


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("tile", [1, 8, "auto"])
def test_unified_knobs_match_jax(pack, radix, layout, tile):
    """Packed survivors, radix 4, both layouts and tiles, including the
    odd-length tails (L odd, f0+v2s odd)."""
    spec = FrameSpec(f=64, v1=20, v2=21, f0=16, v2s=21)
    tf, _ = _both(K7, spec, 640, 1)
    got = _port(tf, K7, spec, pack_survivors=pack, radix=radix,
                layout=layout, frames_per_tile=tile)
    np.testing.assert_array_equal(got, _jax_ref(K7, spec, 640, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_dtypes_match_jax(dtype):
    """bf16 LLRs are cast up to f32 inside, as the JAX kernel does."""
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    np_dtype = np.float32 if dtype == "float32" else jnp.bfloat16
    tf, jf = _both(K7, spec, 400, 2, snr=4.0, dtype=np_dtype)
    want = np.asarray(jref.unified_decode_frames_ref(
        jf.astype(jnp.float32), jmake_trellis(*K7), JFrameSpec(**vars(spec))))
    np.testing.assert_array_equal(_port(tf, K7, spec), want)


@pytest.mark.parametrize("code", [(4, (0o13, 0o15, 0o17)), (5, (0o23, 0o35)),
                                  K7, (9, (0o753, 0o561))])
@pytest.mark.parametrize("spec", [
    FrameSpec(f=64, v1=16, v2=16, f0=16, v2s=16),
    FrameSpec(f=64, v1=16, v2=16),
])
def test_other_codes_match_jax(code, spec):
    """beta=3 and S < 32 (one zero-padded word), packed and not, in the
    sublane layout too."""
    tf, _ = _both(code, spec, 400, 3, snr=6.0)
    want = _jax_ref(code, spec, 400, 3, snr=6.0)
    for pack, radix, layout in [(True, 4, "sublane"), (False, 2, "lane")]:
        got = _port(tf, code, spec, pack_survivors=pack, radix=radix,
                    layout=layout)
        np.testing.assert_array_equal(got, want)


#: The edges of the kernels' warp mapping: S=4 (8 frames per warp), S=32
#: (one register per lane), S=1024 (32 registers per lane, the widest).
EDGE_CODES = [(3, (0o7, 0o5)), (6, (0o65, 0o57)), (11, (0o3345, 0o3613))]


@pytest.mark.parametrize("code", EDGE_CODES)
def test_edge_codes_match_jax(code):
    """The plain version equals JAX on the codes at the edges of the CUDA
    kernels' lane mapping, which tests/test_torch_gpu.py holds the kernel
    to on the card: parallel and serial traceback, packed and not."""
    for spec in (FrameSpec(f=32, v1=12, v2=16, f0=8, v2s=16),
                 FrameSpec(f=32, v1=12, v2=16)):
        tf, _ = _both(code, spec, 96, 7, snr=6.0)
        want = _jax_ref(code, spec, 96, 7, snr=6.0)
        for pack, radix, layout in [(True, 4, "sublane"), (False, 2, "lane")]:
            got = _port(tf, code, spec, pack_survivors=pack, radix=radix,
                        layout=layout, frames_per_tile=2)
            np.testing.assert_array_equal(got, want)


#: Codes past the register mapping, which the CUDA kernels run one block a
#: frame with path metrics in shared memory (tests/test_torch_gpu.py holds
#: them to these plain versions on the card): K=12, K=13 and the Galileo
#: (15, 1/4) code.
LARGE_CODES = [(12, (0o4335, 0o5723)), (13, (0o10533, 0o17661)),
               (15, (0o46321, 0o51271, 0o63667, 0o70535))]


@pytest.mark.parametrize("code", LARGE_CODES)
@pytest.mark.parametrize("spec", [
    FrameSpec(f=32, v1=12, v2=16, f0=8, v2s=16),            # parallel tb
    FrameSpec(f=32, v1=12, v2=16),                           # serial tb
    FrameSpec(f=48, v1=8, v2=20, f0=16, v2s=12, start="fixed"),
])
def test_large_codes_match_jax(code, spec):
    """The unified kernel's plain version equals JAX at k = 12, 13, 15:
    packed and not, radix 2 and 4, both layouts."""
    tf, _ = _both(code, spec, 2 * spec.f, 9, snr=6.0)
    want = _jax_ref(code, spec, 2 * spec.f, 9, snr=6.0)
    for pack, radix, layout in [(True, 4, "sublane"), (False, 2, "lane"),
                                (True, 2, "lane"), (False, 4, "sublane")]:
        got = _port(tf, code, spec, pack_survivors=pack, radix=radix,
                    layout=layout, frames_per_tile=1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", [(4, (0o13, 0o15, 0o17)), K7])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_bf16_branch_metrics_match_jax_kernel(code, layout):
    """bf16 branch metrics round once to nearest even and accumulate in
    f32: the port equals the Pallas kernel (interpret mode) bit for bit."""
    spec = FrameSpec(f=64, v1=20, v2=20, f0=16, v2s=20)
    tf, jf = _both(code, spec, 384, 4, snr=2.0)
    want = np.asarray(jops.viterbi_decode_frames(
        jf, jmake_trellis(*code), JFrameSpec(**vars(spec)), layout=layout,
        bm_dtype="bfloat16", frames_per_tile=8))
    for pack, radix in [(True, 4), (False, 2)]:
        got = _port(tf, code, spec, layout=layout, bm_dtype="bfloat16",
                    pack_survivors=pack, radix=radix)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", [K7, (9, (0o753, 0o561))])
def test_deep_tiles_packed_radix4_match_jax(code):
    spec = FrameSpec(f=64, v1=16, v2=16, f0=16, v2s=16)
    tf, _ = _both(code, spec, 64 * 6, 5, snr=5.0)
    got = _port(tf, code, spec, frames_per_tile=32, pack_survivors=True,
                radix=4)
    np.testing.assert_array_equal(got, _jax_ref(code, spec, 64 * 6, 5, 5.0))


def test_frame_padding_matches_jax():
    """5 frames with a tile of 8: padded, decoded, cut back."""
    spec = FrameSpec(f=64, v1=16, v2=16)
    tf, _ = _both(K7, spec, 64 * 5, 6)
    assert tf.shape[0] == 5
    got = _port(tf, K7, spec, frames_per_tile=8)
    np.testing.assert_array_equal(got, _jax_ref(K7, spec, 64 * 5, 6))


@pytest.mark.parametrize("start", ["boundary", "fixed"])
def test_plain_version_equals_port_ref(start):
    """unified_decode_frames_plain (the kernel's arithmetic) == the port's
    ref (viterbi_forward + traceback) for every knob."""
    spec = FrameSpec(f=48, v1=9, v2=15, f0=12, v2s=13, start=start)
    tr = make_trellis(*K7)
    tf, _ = _both(K7, spec, 300, 7)
    want = ref.unified_decode_frames_ref(tf, tr, spec)
    for pack in (False, True):
        for radix in (2, 4):
            for bm in ("float32",):
                got = vu.unified_decode_frames_plain(
                    tf, trellis=tr, v1=9, f=48, v2=15, f0=12, v2s=13,
                    start=start, frames_per_tile=1, pack_survivors=pack,
                    radix=radix, bm_dtype=bm)
                assert torch.equal(got, want)


def test_cpu_tensor_never_reaches_the_kernel():
    """A CPU tensor goes to the plain version; the CUDA wrapper refuses it
    before building anything, and its launch count does not move."""
    spec = FrameSpec(f=64, v1=16, v2=16)
    tf, _ = _both(K7, spec, 128, 8)
    kw = dict(trellis=make_trellis(*K7), v1=16, f=64, v2=16, f0=64, v2s=16,
              frames_per_tile=1)
    before = vu.unified_decode_frames_cuda.launches
    assert torch.equal(vu.unified_decode_frames(tf, **kw),
                       vu.unified_decode_frames_plain(tf, **kw))
    with pytest.raises(ValueError, match="CUDA device"):
        vu.unified_decode_frames_cuda(tf, **kw)
    assert vu.unified_decode_frames_cuda.launches == before


def test_ops_entry_validation():
    """Mirrors test_faults.test_kernel_ops_entry_validation."""
    spec = FrameSpec(f=64, v1=16, v2=20)
    frames = torch.zeros((4, spec.frame_len, 2))
    tr = make_trellis(*K7)
    kw = dict(frames_per_tile=4, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        ops.viterbi_decode_frames(frames[0], tr, spec, **kw)
    with pytest.raises(ValueError, match="frame_len"):
        ops.viterbi_decode_frames(frames[:, :-1], tr, spec, **kw)
    with pytest.raises(ValueError, match="beta"):
        ops.viterbi_decode_frames(frames[..., :1], tr, spec, **kw)
    with pytest.raises(ValueError, match="floating"):
        ops.viterbi_decode_frames(frames.to(torch.int32), tr, spec, **kw)
    # the split path (unified=False) decodes, to the unified kernel's bits
    split = ops.viterbi_decode_frames(frames, tr, spec, unified=False, **kw)
    assert torch.equal(split, ops.viterbi_decode_frames(frames, tr, spec,
                                                        **kw))


def test_no_card_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = FrameSpec(f=64, v1=16, v2=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.viterbi_decode_frames(torch.zeros((4, spec.frame_len, 2)),
                                  make_trellis(*K7), spec)


def test_kernel_trace_event_records_knobs():
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        ops.viterbi_decode_frames(torch.zeros((3, spec.frame_len, 2)),
                                  make_trellis(*K7), spec, device="cpu",
                                  layout="sublane", radix=2)
    finally:
        obs.set_tracer(prev)
    (ev,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
    assert ev.kind == "span"
    assert ev.attrs["frames"] == 3 and ev.attrs["layout"] == "sublane"
    assert ev.attrs["frames_per_tile"] == autotune.plan_tiles(
        make_trellis(*K7), spec, pack_survivors=True, radix=2,
        layout="sublane", max_frames=3, device="cpu").frames_per_tile
    assert ev.attrs["radix"] == 2 and ev.attrs["device"] == "cpu"
    assert ev.attrs["mapping"] == "plain"             # no launch off the card
    assert tracer.counters() == {}
    assert obs.get_tracer() is obs.NULL_TRACER
