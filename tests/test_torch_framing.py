"""The receiver call's clip and framing (repro_torch.kernels.framing), on
the CPU.

The plain version, which the CPU runs and the framing kernel is held to on
the card (tests/test_torch_gpu_framing.py), must equal the clip and
framing as the receiver call ran them before the kernel, bit for bit, in
every dtype the kernel takes: NaN, +-Inf, values past the clip and -0.0 on
the edges of frames, streams that end mid-frame or before the first
frame's kept stages. The plain version must also equal the JAX package's
clip (``repro.core.pipeline.make_decoder``'s jnp.where and jnp.clip) and
``repro.core.framed.frame_llr`` on the same inputs; the card's tests hold
the kernel to the plain version on those inputs, so the kernel is held to
JAX through it (the card's machine has no JAX). ``make_decoder``'s kernel
backend must decode the bits of its reference backend at every rate, on
poisoned streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import FrameSpec as JFrameSpec
from repro.core.framed import frame_llr as jframe_llr

from repro_torch.core import framed, pipeline
from repro_torch.core.encoder import encode_bits
from repro_torch.core.framed import FrameSpec
from repro_torch.core.puncture import PATTERNS
from repro_torch.core.sanitize import LLR_CLIP
from repro_torch.core.trellis import STD_K7
from repro_torch.kernels import framing

from _torch_framing_cases import (DTYPES, LENGTHS, SPECS, bits, llr_case,
                                  stream_length, todays_frames)

torch.set_num_threads(1)


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_equals_todays_clip_and_frame(dtype, clip, length, spec_name):
    spec, beta = SPECS[spec_name]
    x = llr_case(spec, beta, stream_length(spec, length), dtype)
    want = todays_frames(x, spec, clip)
    got = framing.frame_llr_plain(x, spec, LLR_CLIP if clip else None)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))
    # core.framed.frame_llr, the receiver call's and the mesh client's entry
    got = framed.frame_llr(x, spec, LLR_CLIP if clip else None)
    assert torch.equal(bits(got), bits(want))


_JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64,
               torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}


def _jax_clip_and_frame(x: torch.Tensor, spec: FrameSpec,
                        clip: bool) -> torch.Tensor:
    """The JAX package's receiver call up to the frames: its clip, then
    ``repro.core.framed.frame_llr``; back as a torch tensor of x's dtype."""
    wide = x.float() if x.dtype == torch.bfloat16 else x
    s = jnp.asarray(wide.numpy(), dtype=_JAX_DTYPES[x.dtype])
    if clip:
        s = jnp.clip(jnp.where(jnp.isfinite(s), s, jnp.zeros_like(s)),
                     -LLR_CLIP, LLR_CLIP)
    out = jframe_llr(s, JFrameSpec(**vars(spec)))
    assert out.dtype == _JAX_DTYPES[x.dtype]
    if x.dtype == torch.bfloat16:
        return torch.from_numpy(np.array(out.astype(jnp.float32))
                                ).to(torch.bfloat16)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_equals_the_jax_package(dtype, clip, length, spec_name):
    spec, beta = SPECS[spec_name]
    x = llr_case(spec, beta, stream_length(spec, length), dtype)
    with jax.enable_x64(dtype == torch.float64):
        want = _jax_clip_and_frame(x, spec, clip)
    got = framing.frame_llr_plain(x, spec, LLR_CLIP if clip else None)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_reads_a_strided_stream(dtype):
    spec, beta = SPECS["blocked_b3"]
    wide = llr_case(spec, 2 * beta, stream_length(spec, "ragged"), dtype)
    x = wide[:, ::2]
    assert not x.is_contiguous()
    assert torch.equal(bits(framing.frame_llr_plain(x, spec, LLR_CLIP)),
                       bits(todays_frames(x.contiguous(), spec, True)))


def test_clip_bounds_as_each_dtype_holds_them():
    """What ATen's clamp compares with: 1e6 rounded to the dtype."""
    assert framing._bounds(torch.float32, LLR_CLIP) == (-1e6, 1e6)
    assert framing._bounds(torch.float64, LLR_CLIP) == (-1e6, 1e6)
    assert framing._bounds(torch.float16, LLR_CLIP) == (-np.inf, np.inf)
    assert framing._bounds(torch.bfloat16, LLR_CLIP) == (-999424.0,
                                                         999424.0)


def test_cpu_tensors_take_the_plain_version():
    spec, beta = SPECS["k7_cell"]
    x = llr_case(spec, beta, stream_length(spec, "ragged"), torch.float32)
    before = framing.frame_llr_cuda.launches
    for plain in (False, True):
        got = framed.frame_llr(x, spec, LLR_CLIP, plain=plain)
        assert torch.equal(bits(got), bits(todays_frames(x, spec, True)))
    assert framing.frame_llr_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        framing.frame_llr_cuda(x, spec)


def _stream(rate, n, seed):
    """A noisy received stream of a random codeword, poisoned with NaN,
    +-Inf and values past the clip: (n, 2) at rate 1/2, else the flat
    punctured stream."""
    rng = np.random.default_rng(seed)
    coded = encode_bits(rng.integers(0, 2, n), STD_K7)
    if rate != "1/2":
        mask = np.tile(PATTERNS[rate], (1, -(-n // PATTERNS[rate].shape[1])))
        coded = coded.reshape(-1)[mask.T[:n].reshape(-1).astype(bool)]
    x = 1.0 - 2.0 * coded + 0.6 * rng.standard_normal(coded.shape)
    idx = rng.choice(x.size, size=12, replace=False)
    x.reshape(-1)[idx] = np.resize([np.nan, np.inf, -np.inf, 3e9, -3e9,
                                    -0.0], 12)
    return x.astype(np.float32)


@pytest.mark.parametrize("rate,spec", [
    ("1/2", FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)),
    ("2/3", FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)),
    ("3/4", FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21))])
def test_make_decoder_bits_equal_the_reference_backend(rate, spec):
    n = 6 * spec.f + 5
    stream = _stream(rate, n, seed=5)
    got, want = (pipeline.make_decoder(
        pipeline.DecoderConfig(spec=spec, rate=rate, backend=b),
        device="cpu")(stream, n) for b in ("kernel", "reference"))
    assert torch.equal(got, want)
