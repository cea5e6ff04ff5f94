"""Verification system of paper Fig. 8 (§V-B); port of ``repro.channel.sim``.

bits -> convolutional encoder -> (puncture) -> BPSK -> AWGN(Eb/N0)
     -> (depuncture) -> decoder -> BER vs. the original bits.

Random numbers come from an explicit ``torch.Generator``; tensors are made
on the generator's device. The generator gives other numbers than
``jax.random`` from the same seed, so BERs agree with the JAX package
statistically, not bit for bit.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.special as sps
import torch

from ..core.encoder import encode
from ..core.puncture import depuncture, puncture
from ..core.trellis import STD_K7, Trellis

__all__ = ["bpsk", "awgn", "ber", "simulate", "theoretical_ber",
           "ebn0_distance_metric"]


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """bit 0 -> +1.0, bit 1 -> -1.0 (matches the LLR sign convention)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def awgn(x: torch.Tensor, ebn0_db: float,
         generator: torch.Generator) -> torch.Tensor:
    """AWGN with sigma = 10^(-EbN0dB/20), the paper's simulation recipe."""
    sigma = 10.0 ** (-ebn0_db / 20.0)
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                        device=x.device)
    return x + sigma * noise


def ber(decoded: torch.Tensor, truth: torch.Tensor) -> float:
    return float((decoded != truth).to(torch.float32).mean())


def channel(generator: torch.Generator, n: int, ebn0_db: float,
            rate: str = "1/2", trellis: Trellis = STD_K7):
    """Random bits and their received soft-symbol stream: (bits (n,),
    rx (m,)), punctured at ``rate`` (1/2 keeps every symbol)."""
    dev = generator.device
    bits = torch.randint(0, 2, (n,), generator=generator, device=dev,
                         dtype=torch.int32)
    coded = encode(bits, trellis)                     # (n, beta)
    tx = bpsk(puncture(coded, rate))                  # punctured stream
    return bits, awgn(tx, ebn0_db, generator)


def simulate(generator: torch.Generator, n: int, ebn0_db: float,
             decoder: Callable[[torch.Tensor], torch.Tensor],
             rate: str = "1/2", trellis: Trellis = STD_K7,
             hard: bool = False):
    """Run Fig. 8 once; returns (ber, bits, decoded).

    ``decoder`` maps (n, beta) llr -> (n,) bits. ``hard=True`` slices the
    soft symbols to ±1 (hard decision, paper §II-C)."""
    bits, rx = channel(generator, n, ebn0_db, rate, trellis)
    llr = depuncture(rx, rate, n)                     # (n, beta), 0 = erased
    if hard:
        llr = torch.sign(llr)
    decoded = decoder(llr)
    return ber(decoded, bits), bits, decoded


# ---------------------------------------------------------------------------
# Theory: union bound for the standard K=7 (171,133) code. Distance spectrum
# coefficients c_d (information-bit weights) from the literature.
_SPECTRUM_K7 = {10: 36, 12: 211, 14: 1404, 16: 11633, 18: 77433, 20: 502690}


def _q(x):
    return 0.5 * sps.erfc(np.asarray(x) / np.sqrt(2.0))


def theoretical_ber(ebn0_db: np.ndarray, rate: float = 0.5,
                    spectrum: dict = _SPECTRUM_K7) -> np.ndarray:
    """Union-bound BER for soft-decision ML decoding (tight above ~4 dB)."""
    ebn0 = 10.0 ** (np.asarray(ebn0_db, dtype=np.float64) / 10.0)
    out = np.zeros_like(ebn0)
    for d, c in spectrum.items():
        out = out + c * _q(np.sqrt(2.0 * d * rate * ebn0))
    return out


def ebn0_distance_metric(ebn0_db: np.ndarray, ber_meas: np.ndarray,
                         rate: float = 0.5) -> float:
    """Paper Tables II/III metric: mean horizontal (Eb/N0) distance between
    the measured BER curve and the theoretical one."""
    grid = np.linspace(0.0, 12.0, 1201)
    th = theoretical_ber(grid, rate)
    gaps = []
    for e, b in zip(np.asarray(ebn0_db), np.asarray(ber_meas)):
        if b <= 0 or b >= 0.4:
            continue
        idx = np.searchsorted(-np.log10(th), -np.log10(b))
        idx = min(max(idx, 0), len(grid) - 1)
        gaps.append(e - grid[idx])
    return float(np.mean(gaps)) if gaps else float("nan")
