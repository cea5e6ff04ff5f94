"""Bit-packing of survivor selectors (port of ``repro.kernels.packing``).

The ACS recursion produces one bit of information per (stage, state): the
selector saying which butterfly predecessor survived. Packed, word ``w`` of
a row holds states ``[32w, 32w+32)`` with state ``s`` at bit ``s % 32``;
bit 31 lands in the int32 sign bit. This is the word a CUDA warp builds
with ``__ballot_sync`` when lane ``i`` holds state ``32w + i``, so the
unified kernel's shared-memory survivors and these host-side oracles share
one format.

``Layout`` keeps the JAX package's two orientations: ``LANE`` packs the
trailing axis, ``SUBLANE`` packs axis -2 and leaves a trailing payload axis
(frames) untouched. On the GPU the orientation is only a knob that the
kernel records; both decode identically. Codes with fewer than 32 states
pack into one zero-padded word.
"""
from __future__ import annotations

import enum

import torch

__all__ = ["BITS", "Layout", "packed_width", "pack_bits", "unpack_bits",
           "extract_bit"]

BITS = 32


class Layout(str, enum.Enum):
    """Placement of the packed-word axis."""
    LANE = "lane"         # words trailing: (..., N, W) from (..., N, S)
    SUBLANE = "sublane"   # words at -2:    (..., W, N) from (..., S, N)


def packed_width(n: int) -> int:
    """Number of int32 words needed for ``n`` selector bits (>= 1)."""
    return -(-n // BITS)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with two's-complement wrap."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _pack_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    w = packed_width(n)
    x = x.to(torch.int64).movedim(dim, -1)
    if w * BITS != n:
        x = torch.nn.functional.pad(x, (0, w * BITS - n))
    x = x.reshape(*x.shape[:-1], w, BITS)
    weights = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(
        BITS, dtype=torch.int64, device=x.device)
    return _to_int32((x * weights).sum(-1)).movedim(-1, dim)


def pack_bits(sel: torch.Tensor, layout: Layout = Layout.LANE) -> torch.Tensor:
    """Pack {0,1} selectors into int32 words.

    LANE:    pack axis -1;  (..., n)    -> (..., w).
    SUBLANE: pack axis -2;  (..., n, N) -> (..., w, N).
    """
    return _pack_dim(sel, -1 if Layout(layout) is Layout.LANE else -2)


def unpack_bits(packed: torch.Tensor, n: int,
                layout: Layout = Layout.LANE) -> torch.Tensor:
    """Inverse of pack_bits for either layout (int32 values in {0, 1})."""
    dim = -1 if Layout(layout) is Layout.LANE else -2
    x = packed.to(torch.int32).movedim(dim, -1)
    shifts = torch.arange(BITS, dtype=torch.int32, device=x.device)
    bits = (x[..., None] >> shifts) & 1                  # (..., w, 32)
    bits = bits.reshape(*x.shape[:-1], x.shape[-1] * BITS)[..., :n]
    return bits.movedim(-1, dim)


def extract_bit(packed_row: torch.Tensor, state: torch.Tensor,
                layout: Layout = Layout.LANE) -> torch.Tensor:
    """Selector bit of ``state`` from a packed row.

    LANE:    packed_row (..., w), state broadcast-compatible with (...).
    SUBLANE: packed_row (..., w, N), state (..., N).

    The ``& 1`` after the arithmetic shift makes the sign extension of a
    bit-31 word harmless.
    """
    word_id = state >> 5
    if Layout(layout) is Layout.LANE:
        w = packed_row.shape[-1]
        words = torch.arange(w, dtype=state.dtype, device=state.device)
        onehot = word_id[..., None] == words
        word = (packed_row * onehot).sum(-1)
    else:
        w = packed_row.shape[-2]
        words = torch.arange(w, dtype=state.dtype, device=state.device)[:, None]
        onehot = word_id[..., None, :] == words
        word = (packed_row * onehot).sum(-2)
    return (word.to(torch.int32) >> (state & (BITS - 1)).to(torch.int32)) & 1
