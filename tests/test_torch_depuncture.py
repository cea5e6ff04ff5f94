"""The receiver call's depuncture (repro_torch.core.puncture.depuncture), on
the CPU.

``depuncture`` writes the stream into the (n, beta) grid in one indexed
store at the positions the pattern keeps: it must equal the definition by
a flat index of every kept position over the n stages, bit for bit, in
every dtype, for n below one period and for n that is not a multiple of
it. The receiver call depunctures inside its framing and records the rate
and the symbols on ``decode.frame``. The JAX parity of
the same function is ``tests/test_torch_core.py::
test_puncture_depuncture_equal``; the card's check is
``tests/test_torch_gpu_depuncture.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig, make_decoder

pun = importlib.import_module("repro_torch.core.puncture")

SPEC34 = FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)


def index_definition(stream: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """The depuncture by a flat index of the n * beta positions the pattern
    keeps, tiled over every stage."""
    pattern = pun.PATTERNS[name]
    beta, period = pattern.shape
    mask = np.tile(pattern, (1, -(-n // period))).T[:n]
    keep = np.nonzero(mask.reshape(-1))[0]
    flat = torch.zeros(n * beta, dtype=stream.dtype, device=stream.device)
    flat[torch.as_tensor(keep, device=stream.device)] = stream
    return flat.reshape(n, beta)


def kept_count(name: str, n: int) -> int:
    pattern = pun.PATTERNS[name]
    period = pattern.shape[1]
    return int(np.tile(pattern, (1, -(-n // period))).T[:n].sum())


def _stream(name, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(kept_count(name, n), generator=gen).to(dtype)


def _period(name):
    return pun.PATTERNS[name].shape[1]


@pytest.mark.parametrize("n", [1, 2, "period-1", 3000, 3001, 3002])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("name", ["1/2", "2/3", "3/4"])
def test_depuncture_equals_the_index_definition(name, dtype, n):
    n = _period(name) - 1 if n == "period-1" else n
    stream = _stream(name, n, dtype, seed=n)
    got = pun.depuncture(stream, name, n)
    want = index_definition(stream, name, n)
    assert got.dtype == dtype and got.shape == (n, 2) and got.is_contiguous()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("view", ["offset", "strided"])
@pytest.mark.parametrize("n", [3000, 3001, 3002])
def test_depuncture_of_a_view_of_a_larger_tensor(view, n):
    """A stream that starts inside a larger tensor's storage, or steps
    over every other element of it, depunctures as its own copy does."""
    m = kept_count("3/4", n)
    base = torch.randn(2 * m + 7, generator=torch.Generator().manual_seed(n))
    stream = base[7:7 + m] if view == "offset" else base[7::2][:m]
    want = index_definition(stream.clone(), "3/4", n)
    assert torch.equal(pun.depuncture(stream, "3/4", n), want)


@pytest.mark.parametrize("delta", [-1, 1])
def test_depuncture_refuses_a_stream_of_the_wrong_length(delta):
    n = 3001
    stream = torch.zeros(kept_count("3/4", n) + delta)
    with pytest.raises(ValueError, match="stream length"):
        pun.depuncture(stream, "3/4", n)


@pytest.fixture
def tracer():
    prev = obs.get_tracer()
    t = obs.Tracer()
    obs.set_tracer(t)
    yield t
    obs.set_tracer(prev)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_make_decoder_records_the_rate_and_the_symbols(tracer, backend):
    n = 4 * SPEC34.f + 5
    stream = _stream("3/4", n, torch.float32, seed=3)
    dec = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                     backend=backend), "cpu")
    bits = dec(stream, n)
    assert bits.shape == (n,)
    assert "decode.depuncture" not in [r.name for r in tracer.spans()]
    (span,) = [r for r in tracer.spans() if r.name == "decode.frame"]
    assert span.parent == "decode"
    assert span.attrs == {"rate": "3/4", "symbols": kept_count("3/4", n)}
