"""Seeded traffic for a convolutional-code receiver, in plain torch.

Information bits, the (beta, 1, k) encoder, BPSK and additive white
Gaussian noise, made on the device from one ``torch.Generator`` in a few
large calls. The decoder under test and the reference decoder are both
handed the LLRs made here; nothing here comes from the program.

Code convention (the usual one for the CCSDS and Galileo generators): a
generator is a k-bit integer whose most significant bit taps the current
input bit and whose least significant bit taps the input k-1 stages back;
output bit b of stage t is the parity of ``g_b`` and the last k inputs,
the encoder starting in the all-zero state. BPSK sends bit 0 as +1 and 1
as -1, so a positive LLR favours 0.
"""
from __future__ import annotations

import torch

__all__ = ["generator", "info_bits", "encode", "received_llr", "noise_sigma"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int below 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def info_bits(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform {0, 1} int8 bits of ``shape`` on the generator's device."""
    return torch.randint(0, 2, tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.int8)


def encode(bits: torch.Tensor, k: int, polys) -> torch.Tensor:
    """(..., n) {0, 1} bits -> (..., n, beta) int8 coded bits.

    out[t, b] = XOR over i in 0..k-1 with bit (k-1-i) of polys[b] set of
    bits[t - i], with bits before the first stage 0."""
    n = bits.shape[-1]
    pad = torch.nn.functional.pad(bits, (k - 1, 0))     # (..., n + k - 1)
    cols = []
    for g in polys:
        acc = torch.zeros_like(bits)
        for i in range(k):
            if (int(g) >> (k - 1 - i)) & 1:
                acc ^= pad[..., k - 1 - i:k - 1 - i + n]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def noise_sigma(ebn0_db: float) -> float:
    """The noise's standard deviation for unit-energy symbols:
    10^(-Eb/N0 / 20), the paper's simulation recipe. It is exact at rate
    1/2 (Eb = 2 Es, N0 = 2 sigma^2); at rate 1/beta the channel's true
    Eb/N0 lies 10 log10(beta / 2) dB above the stated one."""
    return 10.0 ** (-float(ebn0_db) / 20.0)


def received_llr(coded: torch.Tensor, ebn0_db: float,
                 gen: torch.Generator) -> torch.Tensor:
    """BPSK over AWGN: float32 soft symbols 1 - 2c + sigma * N(0, 1), the
    LLR up to a positive scale (the Viterbi decision does not depend on
    it)."""
    noise = torch.randn(coded.shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
    return (1.0 - 2.0 * coded.to(torch.float32)).add_(
        noise.mul_(noise_sigma(ebn0_db)))
