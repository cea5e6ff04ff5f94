"""The punctured framing kernel (csrc/frame_llr.cu, ``frame_punctured``) on
the card: bit for bit against its plain version
(``framing.frame_punctured_plain``, which the CPU tests in
tests/test_torch_punctured_framing.py hold to the receiver call's old chain
and to the JAX package) and against that chain run by ATen on the card, at
the k7_r34_batch call's shape and at the CPU tests' shapes; a rate-3/4
``make_decoder`` kernel call against its reference backend; one such call
under the profiler: the new kernel under ``decode.frame`` and B1 are its
only launches; and a rate-1/2 call still takes the rate-1/2 framing kernel.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_punctured.py``.
Imports no JAX.
"""
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.channel.sim import channel
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.sanitize import LLR_CLIP
from repro_torch.kernels import framing, ops

from _torch_framing_cases import (DTYPES, PLANTED, PUNCTURED,
                                  PUNCTURED_LENGTHS, SPECS, bits, llr_case,
                                  punctured_length, symbols, symbols_case,
                                  todays_punctured_frames)

pytestmark = pytest.mark.gpu

SPEC34 = PUNCTURED["3/4"]
#: The k7_r34_batch call: 2^24 stages, 66576 frames, B1's tile 64.
CELL_N, CELL_ROWS = 1 << 24, 66624


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel(x, rate, n, rows=None):
    before = framing.frame_punctured_cuda.launches
    out = framing.frame_punctured_cuda(x, rate, n, PUNCTURED[rate], LLR_CLIP,
                                       rows)
    torch.cuda.synchronize()
    assert framing.frame_punctured_cuda.launches == before + 1
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["F", "to_tile"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate,length", PUNCTURED_LENGTHS)
def test_kernel_equals_plain(cuda, rate, length, dtype, padded):
    n = punctured_length(rate, length)
    x = symbols_case(rate, n, dtype, seed=n)
    F = PUNCTURED[rate].num_frames(n)
    rows = ops.tile_rows(F, 64) if padded else None
    got = _kernel(x.to(cuda), rate, n, rows)
    assert got.dtype == dtype and got.is_contiguous()
    plain = framing.frame_punctured_plain(x, rate, n, PUNCTURED[rate],
                                          LLR_CLIP, rows)
    assert torch.equal(bits(got.cpu()), bits(plain))
    todays = todays_punctured_frames(x.to(cuda), rate, n, rows)
    assert torch.equal(bits(got), bits(todays))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate", list(PUNCTURED))
def test_a_view_of_a_larger_tensor(cuda, rate, dtype, offset):
    """A stream that starts ``offset`` elements into a larger tensor's
    storage (off every 16-byte boundary), and one that steps over every
    other element of it (copied contiguous first)."""
    n = punctured_length(rate, "tail1")
    m = symbols(rate, n)
    base = symbols_case(rate, 2 * n + 8, dtype, seed=offset).to(cuda)
    for x in (base[offset:offset + m], base[offset::2][:m]):
        got = _kernel(x, rate, n, PUNCTURED[rate].num_frames(n) + 3)
        want = framing.frame_punctured_plain(x.cpu(), rate, n,
                                             PUNCTURED[rate], LLR_CLIP,
                                             got.shape[0])
        assert torch.equal(bits(got.cpu()), bits(want))


def _cell_stream(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    _, rx = channel(gen, CELL_N, 5.5, rate="3/4")
    idx = torch.randint(0, rx.numel(), (4096,), generator=gen, device=cuda)
    poison = torch.tensor(PLANTED, dtype=rx.dtype, device=cuda)
    rx[idx] = poison[torch.arange(idx.numel(), device=cuda) % poison.numel()]
    return rx


def test_kernel_equals_plain_at_the_cell(cuda):
    rx = _cell_stream(cuda, 1)
    assert rx.shape == (symbols("3/4", CELL_N),)
    got = _kernel(rx, "3/4", CELL_N, CELL_ROWS)
    assert got.shape == (CELL_ROWS, SPEC34.frame_len, 2)
    want = framing.frame_punctured_plain(rx, "3/4", CELL_N, SPEC34, LLR_CLIP,
                                         CELL_ROWS)
    assert torch.equal(bits(got), bits(want))
    del want
    todays = todays_punctured_frames(rx, "3/4", CELL_N, CELL_ROWS)
    assert torch.equal(bits(got), bits(todays))


def test_kernel_backend_equals_the_reference_backend_at_the_cell(cuda):
    """k7_r34_batch's call, poisoned: the kernel backend (one launch of the
    punctured kernel, none of the rate-1/2 one) decodes the reference
    backend's bits (``frame_punctured_plain`` on the card, no framing
    launch)."""
    rx = _cell_stream(cuda, 2)
    got, launches = {}, {}
    for backend in ("kernel", "reference"):
        decode = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                            backend=backend), cuda)
        before = (framing.frame_punctured_cuda.launches,
                  framing.frame_llr_cuda.launches)
        got[backend] = decode(rx, CELL_N)
        torch.cuda.synchronize()
        launches[backend] = (framing.frame_punctured_cuda.launches
                             - before[0],
                             framing.frame_llr_cuda.launches - before[1])
    assert launches == {"kernel": (1, 0), "reference": (0, 0)}
    assert got["kernel"].shape == (CELL_N,)
    assert torch.equal(got["kernel"], got["reference"])


@pytest.mark.parametrize("knobs", [
    dict(backend="kernel_split"), dict(backend="kernel", frames_per_tile=4),
    dict(backend="kernel", block_frames=6, overlap=45),
    dict(backend="kernel_split", block_frames=6, overlap=45)],
    ids=["split", "tile4", "blocked", "split_blocked"])
def test_other_knobs_equal_the_reference_backend(cuda, knobs):
    """The split path (its own tile plan), a fixed tile, and the blocked
    decode (the kernel writes F rows; the block reframe pads after it):
    each decodes the reference backend's bits with the same blocks."""
    n = (1 << 20) + 1
    gen = torch.Generator(device=cuda).manual_seed(14)
    _, rx = channel(gen, n, 5.5, rate="3/4")
    block = {k: v for k, v in knobs.items() if k != "backend"
             and k != "frames_per_tile"}
    got = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4", **knobs),
                       cuda)(rx, n)
    want = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4", **block),
                        cuda)(rx, n)
    assert got.shape == (n,) and torch.equal(got, want)


def _profiled(fn):
    """The device operations' names (user annotations left out) and the
    host events of ``fn()``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e.name for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("decode")]
    return dev, [e for e in events if e.device_type == DeviceType.CPU]


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


def test_one_rate_34_call_launches_the_kernel_and_b1(cuda):
    """One rate-3/4 call on the card: no ``decode.sanitize`` or
    ``decode.depuncture`` span; under ``decode.frame`` (attributes rate and
    symbols) one runtime launch, the punctured kernel's; nothing queued
    under ``decode.pad``; the whole call queues two launches, that kernel
    and B1, and no copy. Read from the host's side of the trace, and from
    the device's where the profiler kept its records: the only kernel
    that is not B1 is the punctured one."""
    n = 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(13)
    _, rx = channel(gen, n, 5.5, rate="3/4")
    decode = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                        backend="kernel"), cuda)
    want = decode(rx, n)                                # builds, plans
    got = []
    before = framing.frame_punctured_cuda.launches
    dev, host = _profiled(lambda: got.append(decode(rx, n)))
    assert framing.frame_punctured_cuda.launches == before + 1
    assert torch.equal(got[0], want)
    names = [e.name for e in host]
    assert "decode.sanitize" not in names and \
        "decode.depuncture" not in names
    assert names.count("decode.plan") == 1
    frame = _inside(host, "decode.frame")
    assert [s[:16] for s in _launches(frame)] == ["cudaLaunchKernel"], frame
    assert not _launches(_inside(host, "decode.pad"))
    call = _launches(_inside(host, "decode"))
    assert len(call) == 2 and all(s.startswith("cudaLaunchKernel")
                                  for s in call), call
    assert not [s for s in dev if "emcpy" in s or "emset" in s], dev
    assert not [s for s in dev if "viterbi_unified" not in s
                and "frame_punctured" not in s], dev


def test_a_rate_12_call_keeps_the_rate_12_kernel(cuda):
    spec, beta = SPECS["k7_cell"]
    n = 64 * spec.f
    x = llr_case(spec, beta, n, torch.float32).to(cuda)
    decode = make_decoder(DecoderConfig(spec=spec, backend="kernel"), cuda)
    before = (framing.frame_llr_cuda.launches,
              framing.frame_punctured_cuda.launches)
    decode(x, n)
    torch.cuda.synchronize()
    assert (framing.frame_llr_cuda.launches - before[0],
            framing.frame_punctured_cuda.launches - before[1]) == (1, 0)
