"""The clip-and-frame kernel (csrc/frame_llr.cu) on the card, against its
plain version and against the receiver call's clip and framing as ATen ran
them on the card before the kernel, bit for bit; ``make_decoder``'s kernel
backend, which frames through it, against its reference backend, which
keeps the plain torch ops. The CPU tests (tests/test_torch_framing.py)
hold the plain version to the JAX package on the same inputs.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_framing.py``.
Imports no JAX.
"""
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.channel.sim import channel
from repro_torch.core import framed
from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.sanitize import LLR_CLIP
from repro_torch.kernels import framing

from _torch_framing_cases import (DTYPES, LENGTHS, PLANTED, SPECS, bits,
                                  llr_case, stream_length, todays_frames)

pytestmark = pytest.mark.gpu

CELL = SPECS["k7_cell"][0]
#: The benchmark cells' calls: k7_r12_batch, k7_r12_mesh4 (framed on the
#: home card) and galileo_k15_batch.
CELL_SHAPES = [(1 << 24, 2), (1 << 26, 2), (1 << 20, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel(x, spec, clip):
    before = framing.frame_llr_cuda.launches
    out = framed.frame_llr(x, spec, LLR_CLIP if clip else None)
    torch.cuda.synchronize()
    assert framing.frame_llr_cuda.launches == before + 1
    return out


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_equals_plain(cuda, dtype, clip, length, spec_name):
    spec, beta = SPECS[spec_name]
    x = llr_case(spec, beta, stream_length(spec, length), dtype)
    got = _kernel(x.to(cuda), spec, clip)
    assert got.dtype == dtype and got.is_contiguous()
    plain = framing.frame_llr_plain(x, spec, LLR_CLIP if clip else None)
    assert torch.equal(bits(got.cpu()), bits(plain))
    todays = todays_frames(x.to(cuda), spec, clip)
    assert torch.equal(bits(got), bits(todays))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("spec,beta", [
    (CELL, 2), (CELL, 3), (FrameSpec(f=2, v1=1, v2=0), 1)],
    ids=["cell_b2", "cell_b3", "frames_shorter_than_a_vector"])
def test_every_alignment_of_the_stream(cuda, spec, beta, dtype, offset):
    """A stream that starts ``offset`` elements past a 16-byte boundary:
    each width of load (16, 8, 4 and 2 bytes) and the element-wise
    edges, frames of fewer elements than a 16-byte vector too."""
    n = 7 * spec.f + 3
    flat = llr_case(spec, 1, n * beta + offset, dtype, seed=offset)[:, 0]
    x = flat.to(cuda)[offset:].view(n, beta)
    assert x.is_contiguous()
    for clip in (True, False):
        got = _kernel(x, spec, clip)
        want = framing.frame_llr_plain(x.cpu(), spec,
                                       LLR_CLIP if clip else None)
        assert torch.equal(bits(got.cpu()), bits(want))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("n,beta", CELL_SHAPES)
def test_kernel_equals_plain_at_the_cells_shapes(cuda, n, beta, clip):
    gen = torch.Generator(device=cuda).manual_seed(n + beta)
    x = torch.randn((n, beta), generator=gen, device=cuda) * 3
    idx = torch.randint(0, n * beta, (4096,), generator=gen, device=cuda)
    poison = torch.tensor(PLANTED, dtype=x.dtype, device=cuda)
    x.view(-1)[idx] = poison[torch.arange(idx.numel(), device=cuda)
                             % poison.numel()]
    got = _kernel(x, CELL, clip)
    want = framing.frame_llr_plain(x, CELL, LLR_CLIP if clip else None)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_strided_stream_takes_the_kernel(cuda, dtype):
    spec, beta = SPECS["blocked_b3"]
    n = stream_length(spec, "ragged")
    wide = llr_case(spec, 2 * beta, n, dtype).to(cuda)
    for x in (wide[:, ::2], wide.t().contiguous().t()[:, :beta]):
        assert not x.is_contiguous()
        for clip in (True, False):
            got = _kernel(x, spec, clip)
            want = framing.frame_llr_plain(x.cpu(), spec,
                                           LLR_CLIP if clip else None)
            assert torch.equal(bits(got.cpu()), bits(want))


def _device_ops(fn):
    """The device operations (kernels, copies, fills) of ``fn()``, and the
    trace's host events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e.name for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("decode")]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    return dev, host


def _inside(host, span):
    """The host events inside the one host event named ``span``."""
    (outer,) = [e for e in host if e.name == span]
    lo, hi = outer.time_range.start, outer.time_range.end
    return [e.name for e in host if e is not outer
            and lo <= e.time_range.start and e.time_range.end <= hi]


def _launches(names):
    """The runtime calls that queue device work: one device op each."""
    return [s for s in names
            if s.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))]


@pytest.mark.parametrize("case", ["float64", "strided"])
def test_float64_and_strided_streams_take_the_kernel(cuda, case):
    """A float64 stream runs one device op, the kernel; a strided one is
    copied contiguous first (one ATen copy) and then framed by the
    kernel."""
    spec, beta = CELL, 2
    x = llr_case(spec, 2 * beta, 4 * spec.f + 9, torch.float32).to(cuda)
    x = x[:, :beta].contiguous().double() if case == "float64" \
        else x[:, ::2]
    framed.frame_llr(x, spec, LLR_CLIP)                # the build, once
    dev, _ = _device_ops(lambda: framed.frame_llr(x, spec, LLR_CLIP))
    assert len(dev) == (1 if case == "float64" else 2), dev
    assert "frame_llr" in dev[-1], dev


def test_launches_one_per_call(cuda):
    spec, beta = CELL, 2
    n = 8 * spec.f
    x = llr_case(spec, beta, n, torch.float32).to(cuda)
    decode = make_decoder(DecoderConfig(spec=spec, backend="kernel"), cuda)
    before = framing.frame_llr_cuda.launches
    for _ in range(3):
        decode(x, n)
    assert framing.frame_llr_cuda.launches == before + 3
    framed.frame_llr(x, spec)
    assert framing.frame_llr_cuda.launches == before + 4
    ref = make_decoder(DecoderConfig(spec=spec), cuda)
    ref(x, n)
    framed.frame_llr(x, spec, plain=True)
    assert framing.frame_llr_cuda.launches == before + 4
    torch.cuda.synchronize()


def test_kernel_backend_equals_the_reference_backend_at_the_cell(cuda):
    """k7_r12_batch's call, 2^24 bits of the K=7 rate-1/2 code at the
    paper's frame, noisy and poisoned with NaN, +-Inf, values past the
    clip and -0.0: the kernel backend (one framing-kernel launch) decodes
    the reference backend's bits (plain torch clip and framing, no
    framing-kernel launch)."""
    n = 1 << 24
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = channel(gen, n, 3.0)[1].view(n, 2)
    idx = torch.randint(0, 2 * n, (4096,), generator=gen, device=cuda)
    poison = torch.tensor(PLANTED, dtype=x.dtype, device=cuda)
    x.view(-1)[idx] = poison[torch.arange(idx.numel(), device=cuda)
                             % poison.numel()]
    got, launches = {}, {}
    for backend in ("kernel", "reference"):
        decode = make_decoder(DecoderConfig(spec=CELL, backend=backend),
                              cuda)
        before = framing.frame_llr_cuda.launches
        got[backend] = decode(x, n)
        torch.cuda.synchronize()
        launches[backend] = framing.frame_llr_cuda.launches - before
    assert launches == {"kernel": 1, "reference": 0}
    assert torch.equal(got["kernel"], got["reference"])


def test_only_the_kernel_runs_under_decode_frame(cuda):
    """One rate-1/2 call on the card: no ``decode.sanitize`` span; under
    ``decode.frame`` one runtime launch, the framing kernel's (its count
    rises by one), and no ATen op but the frames' allocation; the whole
    call queues two device ops, the framing kernel and B1. Read from the
    host's side of the trace: in a process that has run many kernels the
    profiler can drop a short session's device records."""
    spec, beta = CELL, 2
    n = 256 * spec.f
    x = llr_case(spec, beta, n, torch.float32).to(cuda)
    decode = make_decoder(DecoderConfig(spec=spec, backend="kernel"), cuda)
    want = decode(x, n)                                 # builds, plans
    got = []
    before = framing.frame_llr_cuda.launches
    _, host = _device_ops(lambda: got.append(decode(x, n)))
    assert framing.frame_llr_cuda.launches == before + 1
    assert torch.equal(got[0], want)
    assert "decode.sanitize" not in [e.name for e in host]
    frame = _inside(host, "decode.frame")
    assert [s[:16] for s in _launches(frame)] == ["cudaLaunchKernel"], frame
    assert not [s for s in frame
                if s.startswith("aten::") and s != "aten::empty"], frame
    call = _launches(_inside(host, "decode"))
    assert len(call) == 2 and all(s.startswith("cudaLaunchKernel")
                                  for s in call), call
    assert [s[:16] for s in _launches(_inside(host, "decode.kernel"))] == \
        ["cudaLaunchKernel"]
