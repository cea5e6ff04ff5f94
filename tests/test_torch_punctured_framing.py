"""The punctured receiver call's clip, depuncture, framing and padding in one
step (repro_torch.kernels.framing.frame_punctured_plain), on the CPU.

The plain version states what the punctured framing kernel computes,
element by element through the pattern's rank table; the card's tests
(tests/test_torch_gpu_punctured.py) hold the kernel to it. Here it must
equal, bit for bit, the chain the receiver call ran on the card before the
kernel (``clip_llr_plain``, ``depuncture``, ``frame_llr_plain``, zero rows
up to the tile's multiple) at rates 2/3 and 3/4, for every tail
``n % period`` and streams shorter than a frame, in every dtype the kernel
takes with NaN, +-Inf, values past the clip and -0.0 planted, and on a
stream that is a view of a larger tensor; and the JAX package's
depuncture and framing on the same inputs. ``make_decoder`` on the CPU
runs it into the tile's rows and decodes the reference backend's bits,
and a changed pattern is seen by its next call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import FrameSpec as JFrameSpec
from repro.core.framed import frame_llr as jframe_llr
from repro.core.puncture import depuncture as jdepuncture

from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.framed import frame_received
from repro_torch.core.pipeline import DecoderConfig, make_decoder, \
    make_frame_decoder
from repro_torch.core.puncture import PATTERNS, _keep_idx
from repro_torch.core.sanitize import LLR_CLIP
from repro_torch.kernels import framing, ops

from _torch_framing_cases import (DTYPES, PUNCTURED, PUNCTURED_LENGTHS, bits,
                                  punctured_length, symbols, symbols_case,
                                  todays_punctured_frames)

torch.set_num_threads(1)

#: B1's tile at the k7_r34_batch cell (66576 frames -> 66624 rows).
TILE = 64


@pytest.mark.parametrize("padded", [False, True], ids=["F", "to_tile"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate,length", PUNCTURED_LENGTHS)
def test_plain_equals_the_chain(rate, length, dtype, padded):
    n = punctured_length(rate, length)
    x = symbols_case(rate, n, dtype, seed=n)
    F = PUNCTURED[rate].num_frames(n)
    rows = ops.tile_rows(F, TILE) if padded else None
    got = framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate],
                                        LLR_CLIP, rows)
    want = todays_punctured_frames(x, rate, n, rows)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.shape[0] == (rows or F)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("view", ["offset", "strided"])
@pytest.mark.parametrize("rate", list(PUNCTURED))
def test_plain_reads_a_view_of_a_larger_tensor(rate, view):
    n = punctured_length(rate, "tail1")
    m = symbols(rate, n)
    base = symbols_case(rate, 2 * n + 7, torch.float32, seed=3)
    x = base[7:7 + m] if view == "offset" else base[7::2][:m]
    assert x.shape == (m,) and x.storage_offset() == 7
    got = framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate],
                                        LLR_CLIP, 2 + PUNCTURED[rate]
                                        .num_frames(n))
    want = todays_punctured_frames(x.clone(), rate, n, got.shape[0])
    assert torch.equal(bits(got), bits(want))


def test_plain_without_the_clip_equals_the_chain_without_it():
    rate = "3/4"
    n = punctured_length(rate, "tail2")
    x = symbols_case(rate, n, torch.float32, seed=5)
    got = framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate])
    want = todays_punctured_frames(x, rate, n, clip=False)
    assert torch.equal(bits(got), bits(want))
    assert not torch.equal(bits(got), bits(todays_punctured_frames(x, rate,
                                                                   n)))


_JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.mark.parametrize("dtype", list(_JAX_DTYPES), ids=str)
@pytest.mark.parametrize("rate,length", PUNCTURED_LENGTHS)
def test_plain_equals_the_jax_package(rate, length, dtype):
    """The JAX package's receiver call up to the frames: its clip,
    ``repro.core.puncture.depuncture`` and ``repro.core.framed.frame_llr``
    (which XLA fuses on the TPU)."""
    n = punctured_length(rate, length)
    x = symbols_case(rate, n, dtype, seed=n + 1)
    with jax.enable_x64(dtype == torch.float64):
        s = jnp.asarray(x.numpy(), dtype=_JAX_DTYPES[dtype])
        s = jnp.clip(jnp.where(jnp.isfinite(s), s, jnp.zeros_like(s)),
                     -LLR_CLIP, LLR_CLIP)
        want = np.array(jframe_llr(jdepuncture(s, rate, n),
                                   JFrameSpec(**vars(PUNCTURED[rate]))))
    got = framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate],
                                        LLR_CLIP)
    assert torch.equal(bits(got), bits(torch.from_numpy(want)))


@pytest.mark.parametrize("name", list(PATTERNS))
def test_rank_table(name):
    """Entry t * beta + b is the index, among the period's kept symbols in
    the order they are sent, of output b at phase t; -1 where dropped."""
    pattern = PATTERNS[name]
    beta, period = pattern.shape
    kept, table = framing.rank_table(name)
    assert kept == int(pattern.sum()) and len(table) == period * beta
    sent = _keep_idx(period, pattern).tolist()    # flat (t, b) positions
    for t in range(period):
        for b in range(beta):
            want = sent.index(t * beta + b) if pattern[b, t] else -1
            assert table[t * beta + b] == want


@pytest.mark.parametrize("rate", list(PUNCTURED))
@pytest.mark.parametrize("delta", [-1, 1])
def test_a_stream_of_the_wrong_length_raises(rate, delta):
    n = punctured_length(rate, "tail1")
    x = torch.zeros(symbols(rate, n) + delta)
    with pytest.raises(ValueError, match="stream length"):
        framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate], LLR_CLIP)


def test_a_two_dimensional_stream_and_too_few_rows_raise():
    rate = "3/4"
    n = punctured_length(rate, "tail0")
    x = torch.zeros(symbols(rate, n))
    with pytest.raises(ValueError, match="stream length"):
        framing.frame_punctured_plain(x.view(-1, 2), rate, n,
                                      PUNCTURED[rate], LLR_CLIP)
    F = PUNCTURED[rate].num_frames(n)
    with pytest.raises(ValueError, match="rows"):
        framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate], LLR_CLIP,
                                      F - 1)
    with pytest.raises(ValueError, match="CUDA device"):
        framing.frame_punctured_cuda(x, rate, n, PUNCTURED[rate], LLR_CLIP)
    with pytest.raises(ValueError, match="punctured rates only"):
        frame_received(torch.zeros(n, 2), n, PUNCTURED[rate], rows=F)


@pytest.mark.parametrize("F,tile,rows", [
    (66576, 64, 66624), (65536, 64, 65536), (1, 64, 64), (64, 64, 64),
    (65, 64, 128), (7, 1, 7), (0, 32, 0)])
def test_tile_rows(F, tile, rows):
    assert ops.tile_rows(F, tile) == rows


@pytest.mark.parametrize("rate", list(PUNCTURED))
def test_frames_padded_to_the_tile_decode_the_same_bits(rate):
    """The receiver call on the CPU takes the card's order: plan the tile
    for F frames, frame into the tile's multiple of rows, decode them all
    at that tile with nothing padded under ``decode.pad``, keep the first
    n bits; equal to the reference backend's call."""
    from _torch_parity import rx
    spec = PUNCTURED[rate]
    n = 4 * spec.f + 5                      # 5 frames, an odd count
    x = torch.from_numpy(rx(n, rate, seed=9))
    cfg = DecoderConfig(spec=spec, rate=rate, backend="kernel")
    F = spec.num_frames(n)
    rows, tile = make_frame_decoder(cfg, "cpu").tiling(F)
    assert rows == ops.tile_rows(F, tile) and rows > F
    decode = make_decoder(cfg, "cpu")
    tracer = obs.ProfiledTracer()
    prev = obs.set_tracer(tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = decode(x, n)
    finally:
        obs.set_tracer(prev)
    (kern,) = [r for r in tracer.spans() if r.name == "decode.kernel"]
    assert kern.attrs["frames"] == rows
    assert kern.attrs["frames_per_tile"] == tile
    padded = [e.name for e in prof.events() if _under(e, "decode.pad")
              and e.name in ("aten::constant_pad_nd", "aten::pad")]
    assert padded == []
    want = make_decoder(DecoderConfig(spec=spec, rate=rate), "cpu")(x, n)
    assert got.shape == (n,) and torch.equal(got, want)


def _under(ev, name):
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        if ev.name == name:
            return True
    return False


@pytest.mark.parametrize("rate", list(PUNCTURED))
def test_a_changed_pattern_is_seen_by_the_next_call(rate, monkeypatch):
    """The pattern's rank table is keyed on its contents: after one call,
    a pattern with its rows swapped changes the next call's bits."""
    from _torch_parity import rx
    spec = PUNCTURED[rate]
    n = 4 * spec.f + 5
    x = torch.from_numpy(rx(n, rate, seed=10))
    decode = make_decoder(DecoderConfig(spec=spec, rate=rate,
                                        backend="kernel"), "cpu")
    first = decode(x, n)
    monkeypatch.setitem(PATTERNS, rate, PATTERNS[rate][::-1].copy())
    assert not torch.equal(decode(x, n), first)
