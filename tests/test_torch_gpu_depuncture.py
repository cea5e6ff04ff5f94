"""The depuncture on the card: equal to the definition by a flat index
over the stages at a deployment's size, and a rate-3/4 ``make_decoder``
call's bits equal to its reference backend's (the receiver call's
punctured framing kernel is tests/test_torch_gpu_punctured.py).
The CPU tests are ``tests/test_torch_depuncture.py``.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_depuncture.py``.
Imports no JAX.
"""
import importlib

import pytest
import torch

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
