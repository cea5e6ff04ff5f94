"""The port's streaming front end (repro_torch.core.stream) against the JAX
package's, on the CPU.

Mirrors tests/test_stream.py: the chunked decode must be bit-identical to
the single-shot decode across backends, chunk geometries, push
raggedness and punctured rates. The same seeded numpy streams go through
both packages: the JAX side on its reference backend (plus one
``backend="kernel"`` case in Pallas interpret mode), the port with
``device="cpu"``. Also held exactly: the windows a StreamContext
extracts, the window framing at beta=2 and beta=3, and the staging pool's
reuse rule. Tolerance 0 throughout.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_decode, jcfg, rx
from repro.core import stream as jstream
from repro.core.framed import FrameSpec as JFrameSpec
from repro.core.pipeline import make_decoder as jmake_decoder

from repro_torch.core import pipeline as tpipe
from repro_torch.core import stream as tstream
from repro_torch.core.framed import FrameSpec, framed_decode
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.puncture import PATTERNS, depuncture
from repro_torch.core.stream import (StagingPool, StreamContext,
                                     StreamDecoder, make_stream_decoder,
                                     stream_decode)
from repro_torch.core.trellis import make_trellis
from repro_torch.serve import DecodeServer, PlanCache
from repro_torch.serve.plan_cache import build_window_fn

SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
PUNCTURED_SPECS = {
    "2/3": FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20),   # period 2
    "3/4": FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21),   # period 3
}


def _push_all(dec, data, sizes):
    got, i = [], 0
    for sz in sizes:
        sz = min(sz, data.shape[0] - i)
        got.append(dec.push(data[i:i + sz]))
        i += sz
        if i >= data.shape[0]:
            break
    got.append(dec.flush())
    return np.concatenate(got)


@pytest.mark.parametrize("backend", ["reference", "kernel", "kernel_split"])
def test_stream_equals_single_shot_ragged_pushes(backend):
    n = 5000
    llr = rx(n, seed=1)
    cfg = DecoderConfig(spec=SPEC, backend=backend)
    want = jax_decode(cfg, llr, n)
    dec = make_stream_decoder(cfg, chunk_frames=5, device="cpu")
    got = _push_all(dec, llr, (1, 77, 640, 64, 3000, n))
    assert got.shape == (n,) and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(make_decoder(cfg, "cpu")(llr, n).numpy(), want)


def test_stream_decoder_is_reusable_after_flush():
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    dec = make_stream_decoder(cfg, chunk_frames=3, device="cpu")
    for trial in range(2):
        n = 900 + 137 * trial                        # different tails
        llr = rx(n, seed=trial)
        got = np.concatenate([dec.push(llr), dec.flush()])
        assert np.array_equal(got, jax_decode(cfg, llr, n)), trial


def test_stream_kernel_backend_equals_jax_interpret_kernel():
    """The one case against the JAX package's kernel in interpret mode."""
    n = 2000
    llr = rx(n, seed=2)
    cfg = DecoderConfig(spec=SPEC, backend="kernel", layout="sublane")
    want = np.asarray(jmake_decoder(jcfg(cfg))(llr, n))
    assert np.array_equal(stream_decode(cfg, llr, n, chunk_frames=8,
                                        device="cpu"), want)
    assert np.array_equal(
        jstream.stream_decode(jcfg(cfg), llr, n, chunk_frames=8), want)


def test_stream_shorter_than_one_chunk():
    n = 100                                          # < one frame even
    llr = rx(n, seed=3)
    cfg = DecoderConfig(spec=SPEC)
    dec = make_stream_decoder(cfg, chunk_frames=16, device="cpu")
    assert dec.push(llr).size == 0                   # nothing complete yet
    got = dec.flush()[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_default_chunk_comes_from_plan():
    """No explicit chunk_frames: the planner sizes the chunk as 2 tiles x
    devices — the JAX rule, with the port's tile."""
    from repro_torch.kernels.autotune import plan_decode
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    dec = make_stream_decoder(cfg, device="cpu")
    plan = plan_decode(cfg.trellis, SPEC, pack_survivors=cfg.pack_survivors,
                       radix=cfg.radix, bm_dtype=cfg.bm_dtype,
                       layout=cfg.layout, num_devices=1, device="cpu")
    assert dec.chunk_frames == plan.chunk_frames == 2 * plan.frames_per_tile


def test_stream_decode_punctured_rate():
    n = 3024
    stream = rx(n, "3/4", seed=4, snr=6.0)
    cfg = DecoderConfig(spec=PUNCTURED_SPECS["3/4"], rate="3/4",
                        backend="kernel")
    want = jax_decode(cfg, stream, n)
    got = stream_decode(cfg, stream, n, chunk_frames=9, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(
        jstream.stream_decode(jcfg(cfg, backend="reference"), stream, n,
                              chunk_frames=9), want)
    with pytest.raises(ValueError, match="punctured"):
        stream_decode(cfg, stream, device="cpu")     # n is required


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_push_raw_punctured_stream_matches_framed_decode(rate):
    """Raw punctured symbols pushed in ragged slices that cut puncturing
    periods decode like framed_decode of the depunctured stream, and
    like the JAX package's decode."""
    n = 3024
    stream = rx(n, rate, seed=5, snr=6.0)
    spec = PUNCTURED_SPECS[rate]
    cfg = DecoderConfig(spec=spec, rate=rate, backend="kernel")
    full = depuncture(torch.from_numpy(stream), rate, n)
    want = framed_decode(full, cfg.trellis, spec, n).numpy()
    assert np.array_equal(want, jax_decode(cfg, stream, n))
    dec = make_stream_decoder(cfg, chunk_frames=7, device="cpu")
    got = _push_all(dec, stream, (1, 100, 531, 2000, stream.shape[0]))[:n]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_punctured_session_through_server_matches_jax(rate):
    n = 2016
    stream = rx(n, rate, seed=6, snr=6.0)
    cfg = DecoderConfig(spec=PUNCTURED_SPECS[rate], rate=rate)
    srv = DecodeServer(cache=PlanCache(), device="cpu")
    sid = srv.open_session(cfg, chunk_frames=6)
    half = stream.shape[0] // 2
    srv.push(sid, stream[:half])
    srv.step()
    srv.push(sid, stream[half:])
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])[:n]
    assert np.array_equal(got, jax_decode(cfg, stream, n))


def test_punctured_flush_pads_partial_last_stage():
    """A raw stream cut mid-stage flushes the partly filled stage with
    neutral zeros, as the JAX package does."""
    n = 1890
    spec = PUNCTURED_SPECS["3/4"]
    cfg = DecoderConfig(spec=spec, rate="3/4")
    pat = PATTERNS["3/4"]
    m = n * pat.sum() // pat.shape[1]
    raw = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    cut = m - 3
    dec = make_stream_decoder(cfg, chunk_frames=5, device="cpu")
    got = np.concatenate([dec.push(raw[:cut]), dec.flush()])
    jdec = jstream.make_stream_decoder(jcfg(cfg), chunk_frames=5)
    want = np.concatenate([jdec.push(raw[:cut]), jdec.flush()])
    assert got.shape == want.shape == (n - 2,)
    assert np.array_equal(got, want)


def test_stream_decoder_custom_decode_frames_memoized_per_instance():
    n = 15 * 64
    llr = rx(n, seed=8)
    cfg = DecoderConfig(spec=SPEC)
    dec = StreamDecoder(cfg, 5, device="cpu",
                        decode_frames=tpipe._build_frame_decoder(
                            cfg, torch.device("cpu")))
    fns, got = set(), []
    for i in range(0, n, 5 * 64):                    # 3 identical chunks
        got.append(dec.push(llr[i:i + 5 * 64]))
        fns.add(id(dec._window_decoder(5)))
    got.append(dec.flush())
    assert len(fns) == 1 and set(dec._local_fns) == {5}
    assert np.array_equal(np.concatenate(got), jax_decode(cfg, llr, n))


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_context_windows_equal_jax(rate):
    """StreamContext (copied numpy) extracts the JAX context's windows:
    same arrays, frame counts and real-bit counts, through take_windows,
    flush_chunks and flush_window."""
    spec = SPEC if rate == "1/2" else PUNCTURED_SPECS["3/4"]
    n = 11 * spec.f + 7
    data = rx(n, rate, seed=9).reshape(-1)
    cuts = np.sort(np.random.default_rng(9).choice(
        np.arange(1, data.size), 6, replace=False))
    if rate == "1/2":
        cuts = np.unique(cuts // 2) * 2
    out = []
    for mod in (tstream, jstream):
        for flush in ("flush_chunks", "flush_window"):
            ctx = mod.StreamContext(spec, 2, 3, rate)
            wins = []
            for piece in np.split(data, cuts):
                ctx.append(piece)
                wins += ctx.take_windows()
            tail = getattr(ctx, flush)()
            wins += tail if isinstance(tail, list) else [tail]
            out.append([(w.window.tobytes(), w.nframes, w.n_bits,
                         w.frames(spec).tobytes()) for w in wins])
    assert out[:2] == out[2:]
    assert len(out[0]) >= 4


@pytest.mark.parametrize("beta,code", [(2, (7, (0o171, 0o133))),
                                       (3, (4, (0o13, 0o15, 0o17)))])
def test_window_framing_equals_jax_gather(beta, code):
    """The port frames a window on its device with unfold (window axis
    last, then transposed); the JAX package gathers with an index grid.
    Same frames, same bits, at beta=2 and beta=3."""
    spec = FrameSpec(f=32, v1=8, v2=12)
    tr = make_trellis(*code)
    nframes = 5
    win = np.random.default_rng(beta).standard_normal(
        (spec.v1 + nframes * spec.f + spec.v2, beta)).astype(np.float32)
    seen = []
    fn = build_window_fn(spec, lambda fr: seen.append(fr) or fr[:, :spec.f,
                                                                0],
                         nframes)
    fn(torch.from_numpy(win))
    want = tstream.Window(win, nframes, nframes * spec.f).frames(spec)
    jwant = jstream.Window(win, nframes, nframes * spec.f).frames(
        JFrameSpec(**vars(spec)))
    assert seen[0].is_contiguous()
    assert np.array_equal(seen[0].numpy(), want)
    assert np.array_equal(want, jwant)
    cfg = DecoderConfig(trellis=tr, spec=spec, backend="kernel")
    n = nframes * spec.f
    stream = rx(n, seed=beta, trellis=tr)
    assert np.array_equal(
        stream_decode(cfg, stream, n, chunk_frames=2, device="cpu"),
        jax_decode(cfg, stream, n))


def test_staging_pool_reuses_a_slot_only_after_read():
    """A slot goes back to the pool only in read(); until then acquire
    hands out another one. On the CPU there is no event."""
    pool = StagingPool(torch.device("cpu"))
    a = pool.acquire(8, 4)
    b = pool.acquire(8, 4)
    assert a is not b and a.event is None
    dev = pool.stage_in(a, [np.arange(8, dtype=np.float32).reshape(4, 2)])
    assert dev.shape == (4, 2) and torch.equal(
        dev.reshape(-1), torch.arange(8, dtype=torch.float32))
    pool.stage_out(a, torch.tensor([1, 0, 1, 1], dtype=torch.int32))
    assert list(pool.read(a, 3)) == [1, 0, 1]
    assert pool.acquire(8, 4) is a                   # back after read
    pool.read(a, 0)
    c = pool.acquire(16, 4)                          # a is too small: new
    assert c is not a and c.inp.numel() == 16
    pool.read(c, 0)
    assert pool._free == [c]                         # a was dropped


def test_depth_and_host_phases():
    """depth=0 drains every chunk at once, depth=2 trails by two chunks;
    both give the same bits. host_ms() counts the chunks and reports the
    four host phases."""
    n = 12 * 64
    llr = rx(n, seed=10)
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    outs = []
    for depth in (0, 2):
        dec = make_stream_decoder(cfg, chunk_frames=2, depth=depth,
                                  device="cpu")
        first = dec.push(llr[:6 * 64])               # two complete chunks
        assert first.size == (2 * 128 if depth == 0 else 0)
        outs.append(np.concatenate([first, dec.push(llr[6 * 64:]),
                                    dec.flush()]))
        host = dec.host_ms()
        assert host["chunks"] == 6
        assert set(host) == {"framing", "copy_in", "dispatch", "drain",
                             "chunks"}
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], jax_decode(cfg, llr, n))


def test_torch_pushes_and_outputs():
    """Pushes may be torch tensors; bits come back as host int32 numpy."""
    n = 4 * 64
    llr = rx(n, seed=11)
    cfg = DecoderConfig(spec=SPEC)
    got = stream_decode(cfg, torch.from_numpy(llr), n, chunk_frames=2,
                        device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_mesh_and_missing_card_raise(monkeypatch):
    """A mesh must be a FrameMesh (tests/test_torch_distributed.py holds
    the sharded stream); the missing card raises as before."""
    cfg = DecoderConfig(spec=SPEC)
    with pytest.raises(TypeError, match="FrameMesh"):
        make_stream_decoder(cfg, chunk_frames=2, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="FrameMesh"):
        stream_decode(cfg, rx(64), 64, device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_stream_decoder(cfg, chunk_frames=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_decode(cfg, rx(64), 64, chunk_frames=2)
    assert StreamContext(SPEC, 2, 2).chunk_frames == 2   # host-only: fine


@pytest.mark.parametrize("frames,chunk", [(3, 2), (2, 1)])
def test_stream_decode_blocked_matches_single_shot(frames, chunk):
    """Mirrors tests/test_block.py's test of the same name (3 frames,
    chunk 2), and the low-latency serve test's workload (2 frames, chunk
    1): K=7, f=2048, block_frames="auto"; the streamed bits equal the
    port's one-shot decode and the JAX package's."""
    spec = FrameSpec(f=2048, v1=32, v2=32)
    cfg = DecoderConfig(spec=spec, backend="kernel", block_frames="auto")
    n = frames * spec.f
    llr = rx(n, seed=frames, snr=3.0)
    want = jax_decode(cfg, llr, n)
    one = make_decoder(cfg, "cpu")(llr, n).numpy()
    st = stream_decode(cfg, llr, n, chunk_frames=chunk, device="cpu")
    assert np.array_equal(one, want) and np.array_equal(st, want)
