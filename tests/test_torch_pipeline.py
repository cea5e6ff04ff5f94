"""The port's receiver path against the JAX package's, on the CPU.

``repro_torch.core.pipeline.make_decoder(cfg, device="cpu")`` — clip,
depuncture, frame, decode, stitch — must return the same bits as
``repro.core.pipeline.make_decoder`` on the same numpy stream, for the
kernel backend (its plain torch version here) and the reference backend,
at rates 1/2, 2/3 and 3/4, on poisoned streams and under blocking. The
JAX tests hold its kernel backend equal to its reference backend, so the
JAX side runs its reference backend. Tolerance 0 throughout.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core.framed import FrameSpec as JFrameSpec
from repro.core.trellis import make_trellis as jmake_trellis
from repro.serve.checkpoint import encode_cfg

from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core.encoder import encode_bits
from repro_torch.core.framed import FrameSpec
from repro_torch.core.puncture import PATTERNS
from repro_torch.core.trellis import make_trellis
from repro_torch.kernels import viterbi_unified as vu

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
SPECS = {"1/2": FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20),
         "2/3": FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20),
         "3/4": FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)}
_jax_decoders = {}


def _jcfg(tcfg: tpipe.DecoderConfig, **over) -> jpipe.DecoderConfig:
    """The JAX package's config with the same fields."""
    d = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    d["trellis"] = jmake_trellis(tcfg.trellis.k, tcfg.trellis.polys)
    d["spec"] = JFrameSpec(**vars(tcfg.spec))
    d.update(over)
    return jpipe.DecoderConfig(**d)


def _jax_decode(tcfg, stream, n):
    """JAX reference backend on the same config (decoders cached so each
    (config, n) compiles once)."""
    jcfg = _jcfg(tcfg, backend="reference")
    if jcfg not in _jax_decoders:
        _jax_decoders[jcfg] = jpipe.make_decoder(jcfg)
    return np.asarray(_jax_decoders[jcfg](jnp.asarray(stream), n))


def _stream(rate, n, seed, snr=4.0, code=(7, (0o171, 0o133))):
    """Punctured soft-symbol stream (m,) of a random codeword (numpy)."""
    rng = np.random.default_rng(seed)
    coded = encode_bits(rng.integers(0, 2, n), make_trellis(*code))
    pattern = PATTERNS[rate]
    mask = np.tile(pattern, (1, -(-n // pattern.shape[1]))).T[:n]
    kept = coded.reshape(-1)[mask.reshape(-1).astype(bool)]
    sigma = 10.0 ** (-snr / 20.0)
    rx = 1.0 - 2.0 * kept + sigma * rng.standard_normal(kept.shape)
    return rx.astype(np.float32), rng


def _poison(x, rng, mode):
    x = x.copy()
    idx = rng.choice(x.size, size=7, replace=False)
    x.reshape(-1)[idx] = {"nan": np.nan, "inf": np.inf,
                          "huge": 3e9}[mode] * np.where(idx % 2, -1, 1)
    return x


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4"])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("poison", [None, "nan", "inf", "huge"])
def test_make_decoder_matches_jax(rate, backend, poison):
    n = 6 * SPECS[rate].f + 5                      # ragged last frame
    stream, rng = _stream(rate, n, seed=11)
    if poison:
        stream = _poison(stream, rng, poison)
    cfg = tpipe.DecoderConfig(spec=SPECS[rate], rate=rate, backend=backend)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(cfg, stream, n))


@pytest.mark.parametrize("knobs", [
    dict(pack_survivors=False, radix=2, frames_per_tile=8),
    dict(layout="sublane", frames_per_tile=1),
    dict(trellis=make_trellis(5, (0o23, 0o35))),
    dict(trellis=make_trellis(9, (0o753, 0o561)), radix=2),
])
def test_make_decoder_kernel_knobs_match_jax(knobs):
    rate = "1/2"
    trellis = knobs.get("trellis", make_trellis(7, (0o171, 0o133)))
    n = 5 * 64
    stream, _ = _stream(rate, n, seed=12, code=(trellis.k, trellis.polys))
    cfg = tpipe.DecoderConfig(spec=SPECS[rate], backend="kernel", **knobs)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(cfg, stream, n))


@pytest.mark.parametrize("block", [
    dict(block_frames="auto"),                        # engages at f >= 1024
    dict(block_frames=4, overlap=24),
    dict(block_frames=2, overlap=1024),               # >= full_overlap
])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_blocked_decode_matches_jax(block, backend):
    spec = (FrameSpec(f=1024, v1=20, v2=20) if block["block_frames"] == "auto"
            else FrameSpec(f=128, v1=16, v2=20))
    n = 2 * spec.f
    stream, _ = _stream("1/2", n, seed=13, snr=3.0)
    cfg = tpipe.DecoderConfig(spec=spec, backend=backend, **block)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(cfg, stream, n))


@pytest.mark.parametrize("renorm", [0, 3])
def test_reference_renorm_every_matches_jax(renorm):
    spec = SPECS["1/2"]
    n = 4 * spec.f
    stream, _ = _stream("1/2", n, seed=14, snr=2.0)
    cfg = tpipe.DecoderConfig(spec=spec, renorm_every=renorm)
    got = tpipe.make_decoder(cfg, device="cpu")(stream, n)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(cfg, stream, n))


@pytest.mark.parametrize("jcfg", [
    jpipe.DecoderConfig(),
    jpipe.DecoderConfig(spec=JFrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21),
                        rate="3/4", backend="kernel", layout="sublane",
                        bm_dtype="bfloat16", frames_per_tile=16,
                        interpret=False),
    jpipe.DecoderConfig(trellis=jmake_trellis(4, (0o13, 0o15, 0o17)),
                        spec=JFrameSpec(f=256, v1=20, v2=20), radix=2,
                        pack_survivors=False, block_frames=4, overlap=24),
    jpipe.DecoderConfig(backend="kernel_split", renorm_every=1,
                        block_frames="auto"),
])
def test_config_from_dict_roundtrip(jcfg):
    """encode_cfg (the JAX checkpoint codec) -> config_from_dict gives the
    port's config with every field equal."""
    tcfg = convert.config_from_dict(encode_cfg(jcfg))
    assert isinstance(tcfg, tpipe.DecoderConfig)
    assert tcfg.trellis is make_trellis(jcfg.trellis.k, jcfg.trellis.polys)
    assert vars(tcfg.spec) == vars(jcfg.spec)
    for f in convert.CFG_FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert {f.name for f in dataclasses.fields(tcfg)} == \
        {f.name for f in dataclasses.fields(jcfg)}


def test_config_from_dict_decodes_like_jax():
    jcfg = jpipe.DecoderConfig(spec=JFrameSpec(f=64, v1=16, v2=20, f0=16,
                                               v2s=20),
                               rate="2/3", backend="kernel")
    tcfg = convert.config_from_dict(encode_cfg(jcfg))
    n = 5 * 64
    stream, _ = _stream("2/3", n, seed=15)
    got = tpipe.make_decoder(tcfg, device="cpu")(stream, n)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(tcfg, stream, n))


@pytest.mark.parametrize("bad", [
    dict(radix=3), dict(layout="diag"), dict(bm_dtype="float16"),
    dict(renorm_every=-1), dict(backend="kernel", renorm_every=0),
    dict(block_frames=0), dict(overlap=-2), dict(block_frames=3),
    dict(rate="3/4"),
])
def test_config_validation_matches_jax(bad):
    messages = []
    for mod, spec in ((jpipe, JFrameSpec(f=256, v1=20, v2=20)),
                      (tpipe, FrameSpec(f=256, v1=20, v2=20))):
        with pytest.raises(ValueError) as e:
            mod.DecoderConfig(spec=spec, **bad)
        messages.append(str(e.value))
    assert messages[0].replace("Pallas ", "") == messages[1]


def test_no_card_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tpipe.DecoderConfig(backend="kernel")
    for fn in (tpipe.make_decoder, tpipe.make_frame_decoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg, device="cuda")


def test_frame_decoder_memoized_and_split_not_yet_ported():
    """Memoised per (cfg, device). The name predates the split path's port:
    ``kernel_split`` now decodes, to the kernel backend's bits."""
    cfg = tpipe.DecoderConfig(backend="kernel")
    assert tpipe.make_frame_decoder(cfg, "cpu") is \
        tpipe.make_frame_decoder(cfg, "cpu")
    spec = SPECS["1/2"]
    frames = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, spec.frame_len, 2)).astype(np.float32))
    split = tpipe.make_frame_decoder(
        tpipe.DecoderConfig(spec=spec, backend="kernel_split"), "cpu")
    unified = tpipe.make_frame_decoder(
        tpipe.DecoderConfig(spec=spec, backend="kernel"), "cpu")
    assert torch.equal(split(frames), unified(frames))


def test_kernel_backend_on_cpu_launches_nothing():
    cfg = tpipe.DecoderConfig(spec=SPECS["1/2"], backend="kernel")
    before = vu.unified_decode_frames_cuda.launches
    tpipe.make_decoder(cfg, device="cpu")(np.zeros(2 * 128, np.float32), 128)
    assert vu.unified_decode_frames_cuda.launches == before


def test_import_loads_no_jax_and_no_repro():
    """The port imports torch and numpy, never JAX or the JAX package."""
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.channel, repro_torch.obs\n"
        "from repro_torch.kernels import acs, autotune, block, build, ops, "
        "packing, ref, tables, traceback_frames, tunedb, viterbi_fwd, "
        "viterbi_unified\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
