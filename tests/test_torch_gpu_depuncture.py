"""The receiver call's depuncture on the card: equal to the definition by a
flat index over the stages at a deployment's size, no host-to-device copy
under ``decode.depuncture`` (the reference backend's; the kernel
backends' punctured kernel is tests/test_torch_gpu_punctured.py), and a
rate-3/4 ``make_decoder`` call's bits equal to its reference backend's.
The CPU tests are ``tests/test_torch_depuncture.py``.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_depuncture.py``.
Imports no JAX.
"""
import importlib

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.channel.sim import channel
from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig, make_decoder

from test_torch_depuncture import index_definition, kept_count

pytestmark = pytest.mark.gpu

pun = importlib.import_module("repro_torch.core.puncture")

#: The 802.11 rate-3/4 cell's frame (portbench/configs/wifi_k7_r34.json).
SPEC34 = FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("extra", [0, 1, 2])
def test_depuncture_on_the_card_equals_the_index_definition(cuda, extra):
    n = (1 << 22) + extra
    gen = torch.Generator(device=cuda).manual_seed(n)
    stream = torch.randn(kept_count("3/4", n), generator=gen, device=cuda)
    got = pun.depuncture(stream, "3/4", n)
    assert got.device.type == "cuda" and got.shape == (n, 2)
    assert torch.equal(got.view(torch.uint8),
                       index_definition(stream, "3/4", n).view(torch.uint8))


def _profiled(fn):
    """The device operations' names and the host events of ``fn()``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return ([e.name for e in events if e.device_type == DeviceType.CUDA],
            [e for e in events if e.device_type == DeviceType.CPU])


def _inside(host, span):
    """The host events inside the one host event named ``span``."""
    (outer,) = [e for e in host if e.name == span]
    lo, hi = outer.time_range.start, outer.time_range.end
    return [e.name for e in host if e is not outer
            and lo <= e.time_range.start and e.time_range.end <= hi]


def test_a_rate_34_call_copies_nothing_in_under_decode_depuncture(cuda):
    """A rate-3/4 call on a stream that is on the card. The reference
    backend's (the kernel backends depuncture inside the punctured framing
    kernel, with no ``decode.depuncture``): under ``decode.depuncture`` no
    host tensor is moved to the card (no ``aten::_to_copy``) and the device
    work queued is a few slice copies and fills, a count set by the pattern
    and not by n. The kernel backend's: the call's device operations hold
    no host-to-device copy (where the profiler kept them: in a process
    that has run many kernels it can drop a short profile's device
    records)."""
    n = 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(11)
    _, rx = channel(gen, n, 5.0, rate="3/4")
    decode = {b: make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                            backend=b), cuda)
              for b in ("reference", "kernel")}
    want = decode["reference"](rx, n)                   # builds, plans
    got = []
    _, host = _profiled(lambda: got.append(decode["reference"](rx, n)))
    assert torch.equal(got[0], want)
    inner = _inside(host, "decode.depuncture")
    assert "aten::_to_copy" not in inner, inner
    launches = [s for s in inner if s.startswith(
        ("cudaLaunch", "cudaMemcpy", "cudaMemset"))]
    period, beta = pun.PATTERNS["3/4"].shape[1], 2
    assert 1 <= len(launches) <= 2 * period * beta, inner
    assert torch.equal(decode["kernel"](rx, n), want)
    dev, _ = _profiled(lambda: decode["kernel"](rx, n))
    assert not [s for s in dev if "HtoD" in s], dev


def test_a_rate_34_call_equals_the_reference_backend(cuda):
    n = 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(12)
    bits, rx = channel(gen, n, 5.0, rate="3/4")
    got = {}
    for backend in ("kernel", "reference"):
        decode = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                            backend=backend), cuda)
        got[backend] = decode(rx, n)
    torch.cuda.synchronize()
    assert torch.equal(got["kernel"], got["reference"])
    assert float((got["kernel"] != bits).float().mean()) < 1e-2
