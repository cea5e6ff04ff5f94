"""Shared helpers of the port's parity tests against the JAX package
(tests/test_torch_stream.py, _serve, _checkpoint, _faults, _obs): one
numpy input, made from a seed, goes through both packages.

``rx(n, rate, seed)`` is a noisy received stream of a random codeword:
(n, beta) soft symbols at rate 1/2, the raw punctured flat stream
otherwise. ``jcfg(tcfg)`` is the JAX package's DecoderConfig with the
same fields as a port config.
"""
import dataclasses

import numpy as np
import torch

from repro.core import pipeline as jpipe
from repro.core.framed import FrameSpec as JFrameSpec
from repro.core.trellis import make_trellis as jmake_trellis

from repro_torch.core.encoder import encode_bits
from repro_torch.core.puncture import PATTERNS
from repro_torch.core.trellis import STD_K7

# the tests' tensors are tiny: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)


def rx(n, rate="1/2", seed=0, snr=4.0, trellis=STD_K7):
    rng = np.random.default_rng(seed)
    coded = encode_bits(rng.integers(0, 2, n), trellis)       # (n, beta)
    if rate != "1/2":
        pat = PATTERNS[rate]
        mask = np.tile(pat, (1, -(-n // pat.shape[1]))).T[:n]
        sym = coded.reshape(-1)[mask.reshape(-1).astype(bool)]
    else:
        sym = coded
    sigma = 10.0 ** (-snr / 20.0)
    out = 1.0 - 2.0 * sym + sigma * rng.standard_normal(sym.shape)
    return out.astype(np.float32)


def jcfg(tcfg, **over):
    """The JAX package's config with the same fields as ``tcfg``."""
    d = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    d["trellis"] = jmake_trellis(tcfg.trellis.k, tcfg.trellis.polys)
    d["spec"] = JFrameSpec(**vars(tcfg.spec))
    d.update(over)
    return jpipe.DecoderConfig(**d)


_decoders = {}


def jax_decode(tcfg, stream, n):
    """The JAX package's make_decoder on its reference backend (its tests
    hold the kernel backends equal to it), compiled once per config."""
    cfg = jcfg(tcfg, backend="reference")
    if cfg not in _decoders:
        _decoders[cfg] = jpipe.make_decoder(cfg)
    return np.asarray(_decoders[cfg](np.asarray(stream), n))


def counters(snapshot):
    """A metrics snapshot without its clocks (and without the fields that
    carry a bucket id or a tile's padding): what two packages running the
    same workload must agree on exactly."""
    clocks = {"p50_ms", "p99_ms", "uptime_s", "mbps"}
    tot = {k: v for k, v in snapshot["totals"].items() if k not in clocks}
    stages = {k: v["count"] for k, v in snapshot["stages"].items()}
    cache = {k: v for k, v in snapshot["plan_cache"].items()
             if k != "build_ms"}
    return {"totals": tot, "stages": stages, "plan_cache": cache,
            "sessions": snapshot["sessions"],
            "quarantined_sessions": snapshot["quarantined_sessions"],
            "breakers": sorted(tuple(sorted(b.items()))
                               for b in snapshot["breakers"].values()),
            "checkpoint": snapshot["checkpoint"],
            "draining": snapshot["draining"],
            "faults": snapshot.get("faults")}
