"""Trellis (encoder FSM) construction for convolutional codes (beta, 1, k).

All tables are static numpy arrays, computed once on the host from (k,
generator polynomials); the torch code and the CUDA kernel receive them as
small tensors. This module is a copy of ``repro.core.trellis`` (numpy only):
the port imports nothing of the JAX package.

Conventions (DESIGN.md §8):
  state s = (in_{t-1}, ..., in_{t-k+1})           -- k-1 bits, MSB = newest
  word  w = (in_t << (k-1)) | s                   -- k bits
  out bit b = parity(g_b & w)                     -- eq. (1) of the paper
  next state s' = w >> 1 = (in_t << (k-2)) | (s >> 1)
  predecessors of j: {(2j) mod S, (2j+1) mod S}   -- butterfly
  branch input into j: j >> (k-2)                 -- Alg. 2 line 4
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["Trellis", "make_trellis", "STD_K7", "popcount"]


def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized population count for small ints."""
    x = np.asarray(x, dtype=np.uint32)
    out = np.zeros_like(x)
    while np.any(x):
        out = out + (x & 1)
        x = x >> 1
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Trellis:
    """Static trellis tables for a (beta, 1, k) convolutional code.

    ``eq=False`` ⇒ identity hash/eq: instances come from the lru_cached
    ``make_trellis``, so identity is canonical and the object can key the
    decoder caches.
    """

    k: int                     # constraint length
    beta: int                  # output bits per input bit (1/rate)
    polys: tuple               # beta generator polynomials (k-bit ints)

    # -- encoder view: indexed by [state, input_bit] --
    next_state: np.ndarray     # (S, 2) int32
    out_bits: np.ndarray       # (S, 2) int32, beta-bit branch output word

    # -- decoder view: indexed by [state_j, pred 0/1] --
    prev_state: np.ndarray     # (S, 2) int32: {2j mod S, 2j+1 mod S}
    prev_out: np.ndarray       # (S, 2) int32: branch output word on edge i->j
    branch_input: np.ndarray   # (S,)  int32: input bit that leads INTO state j

    # -- branch-metric compression tables (paper §IV-B) --
    # delta(o) = sum_b (-1)^{o[b]} llr[b].  Only 2^beta distinct values per
    # stage; and delta(~o) = -delta(o), so 2^(beta-1) magnitudes suffice.
    # sign table maps an output word o to (index into 2^(beta-1) table, sign).
    bm_index: np.ndarray       # (2^beta,) int32 index into compressed table
    bm_sign: np.ndarray        # (2^beta,) int32 in {+1,-1}
    out_signs: np.ndarray      # (2^beta, beta) float32: (-1)^{o[b]} full table

    @property
    def num_states(self) -> int:
        return 1 << (self.k - 1)

    @property
    def rate_inv(self) -> int:
        return self.beta

    def encode_word(self, state: int, bit: int) -> int:
        return int(self.out_bits[state, bit])


@lru_cache(maxsize=None)
def make_trellis(k: int, polys: tuple) -> Trellis:
    """Build the static trellis for constraint length ``k`` and ``polys``.

    ``polys`` are k-bit integers (e.g. 0o171, 0o133 for the standard K=7
    rate-1/2 code of paper Fig. 1).
    """
    beta = len(polys)
    assert beta >= 2, "beta >= 2 per paper §II-A"
    S = 1 << (k - 1)
    states = np.arange(S, dtype=np.int64)

    next_state = np.zeros((S, 2), dtype=np.int32)
    out_bits = np.zeros((S, 2), dtype=np.int32)
    for b in (0, 1):
        w = (b << (k - 1)) | states                       # k-bit word
        next_state[:, b] = (w >> 1).astype(np.int32)
        word = np.zeros(S, dtype=np.int64)
        for bi, g in enumerate(polys):
            bit = popcount(np.bitwise_and(w, g)) & 1      # parity(g & w)
            # output word stores poly 0 in the MSB position (bit beta-1-bi)
            word |= bit.astype(np.int64) << (beta - 1 - bi)
        out_bits[:, b] = word.astype(np.int32)

    # decoder tables -------------------------------------------------------
    j = states
    j_low = j & ((S >> 1) - 1) if S > 1 else j * 0
    prev_state = np.stack([2 * j_low, 2 * j_low + 1], axis=1).astype(np.int32)
    branch_input = (j >> (k - 2)).astype(np.int32)
    prev_out = np.zeros((S, 2), dtype=np.int32)
    for p in (0, 1):
        prev_out[:, p] = out_bits[prev_state[:, p], branch_input]
    # sanity: next_state[prev_state[j,p], branch_input[j]] == j
    for p in (0, 1):
        assert np.all(next_state[prev_state[:, p], branch_input] == j)

    # branch-metric compression (paper eqs. 7-9) ---------------------------
    n_out = 1 << beta
    half = n_out >> 1
    owords = np.arange(n_out)
    # complement pairs: o and (n_out-1) ^ o have negated metrics (eq. 8)
    bm_index = np.where(owords < half, owords, (n_out - 1) ^ owords).astype(np.int32)
    bm_sign = np.where(owords < half, 1, -1).astype(np.int32)
    # full sign table (-1)^{o[b]}; bit b of the word counts from MSB=poly 0
    out_signs = np.zeros((n_out, beta), dtype=np.float32)
    for o in range(n_out):
        for bi in range(beta):
            bit = (o >> (beta - 1 - bi)) & 1
            out_signs[o, bi] = 1.0 - 2.0 * bit
    return Trellis(
        k=k, beta=beta, polys=tuple(int(p) for p in polys),
        next_state=next_state, out_bits=out_bits,
        prev_state=prev_state, prev_out=prev_out, branch_input=branch_input,
        bm_index=bm_index, bm_sign=bm_sign, out_signs=out_signs,
    )


#: The widely-used standard (2,1,7) code with generators 171, 133 (octal) —
#: paper Fig. 1 and §V-A.
STD_K7 = make_trellis(7, (0o171, 0o133))
