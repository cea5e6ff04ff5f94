"""Puncturing / de-puncturing (paper §IV-E); port of ``repro.core.puncture``.

A pattern is a (beta, period) 0/1 mask over the rate-1/2 mother code;
0-marked symbols are dropped by the transmitter and re-inserted as neutral
zero LLRs by the receiver. Frames must start at a pattern boundary
(``check_alignment``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["PATTERNS", "puncture", "depuncture", "check_alignment",
           "punctured_rate"]

# pattern[b, t]: keep output bit b at phase t (mother code beta=2)
PATTERNS: dict[str, np.ndarray] = {
    "1/2": np.array([[1], [1]], dtype=np.int32),
    "2/3": np.array([[1, 1], [1, 0]], dtype=np.int32),
    "3/4": np.array([[1, 1, 0], [1, 0, 1]], dtype=np.int32),
}


def punctured_rate(name: str) -> float:
    p = PATTERNS[name]
    return p.shape[1] / p.sum()


def _keep_idx(n: int, pattern: np.ndarray) -> np.ndarray:
    """Flat (n*beta) positions that the pattern keeps, in stream order."""
    period = pattern.shape[1]
    reps = -(-n // period)
    mask = np.tile(pattern, (1, reps)).T[:n]          # (n, beta)
    return np.nonzero(mask.reshape(-1))[0]


def puncture(coded: torch.Tensor, name: str) -> torch.Tensor:
    """(n, beta) symbols -> (m,) punctured flat stream."""
    keep = _keep_idx(coded.shape[0], PATTERNS[name])
    return coded.reshape(-1)[torch.as_tensor(keep, device=coded.device)]


def _runs(positions) -> tuple:
    """Runs of consecutive entries of sorted ``positions``: (start, stop,
    j), j the index in ``positions`` of the run's first entry."""
    runs = []
    for j, p in enumerate(positions):
        if runs and runs[-1][1] == p:
            runs[-1][1] = p + 1
        else:
            runs.append([p, p + 1, j])
    return tuple(map(tuple, runs))


@functools.lru_cache(maxsize=None)
def _table(mask: tuple, r: int) -> tuple:
    """For the pattern ``mask`` (nested tuples): the symbols a period keeps
    and their runs of consecutive grid columns, then the same for the
    first r stages of a period."""
    pattern = np.array(mask)
    cols = _keep_idx(pattern.shape[1], pattern).tolist()
    tail = _keep_idx(r, pattern).tolist()
    return len(cols), _runs(cols), len(tail), _runs(tail)


def depuncture(stream: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """(m,) received symbols -> (n, beta) llr grid with neutral zeros.

    The first n // period periods are a (q, kept) view of the stream
    written into a zeroed (q, period * beta) grid through the period's kept
    positions, one strided copy a run of consecutive kept columns, then
    the n % period tail stages the same way: no index over the n stages
    is built on the host and nothing copied to the stream's device grows
    with n."""
    pattern = PATTERNS[name]
    beta, period = pattern.shape
    q, r = divmod(n, period)
    kept, runs, tail_kept, tail_runs = _table(
        tuple(map(tuple, pattern.tolist())), r)
    body = q * kept
    if stream.shape[0] != body + tail_kept:
        raise ValueError(
            f"stream length {stream.shape[0]} != expected "
            f"{body + tail_kept}")
    width = period * beta
    grid = stream.new_zeros((q + (r > 0)) * width)
    src = stream.contiguous()

    def place(rows, row0, count, first, cols):
        """Rows row0.. of the grid from ``rows`` rows of ``count`` symbols
        from symbol ``first`` on, one strided copy a run."""
        for a, b, j in cols:
            grid.as_strided((rows, b - a), (width, 1), row0 * width + a
                            ).copy_(src.as_strided(
                                (rows, b - a), (count, 1),
                                src.storage_offset() + first + j))
    if q:
        place(q, 0, kept, 0, runs)
    if r:
        place(1, q, tail_kept, body, tail_runs)
    return grid.as_strided((n, beta), (beta, 1))


def check_alignment(f: int, v1: int, v2: int, name: str) -> None:
    """Paper §IV-E: f, v1, v2 must be multiples of the pattern period so all
    frames start at a mask boundary."""
    period = PATTERNS[name].shape[1]
    for nm, v in (("f", f), ("v1", v1), ("v2", v2)):
        if v % period:
            raise ValueError(f"{nm}={v} not a multiple of pattern period "
                             f"{period} for rate {name}")
