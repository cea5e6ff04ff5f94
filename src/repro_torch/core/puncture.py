"""Puncturing / de-puncturing (paper §IV-E); port of ``repro.core.puncture``.

A pattern is a (beta, period) 0/1 mask over the rate-1/2 mother code;
0-marked symbols are dropped by the transmitter and re-inserted as neutral
zero LLRs by the receiver. Frames must start at a pattern boundary
(``check_alignment``).
"""
from __future__ import annotations

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


def depuncture(stream: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """(m,) received symbols -> (n, beta) llr grid with neutral zeros: one
    indexed store of the stream at the positions the pattern keeps, as in
    the JAX package."""
    pattern = PATTERNS[name]
    keep = _keep_idx(n, pattern)
    if stream.shape[0] != keep.shape[0]:
        raise ValueError(
            f"stream length {stream.shape[0]} != expected {keep.shape[0]}")
    flat = stream.new_zeros(n * pattern.shape[0])
    flat[torch.as_tensor(keep, device=stream.device)] = stream
    return flat.reshape(n, pattern.shape[0])


def check_alignment(f: int, v1: int, v2: int, name: str) -> None:
    """Paper §IV-E: f, v1, v2 must be multiples of the pattern period so all
    frames start at a mask boundary."""
    period = PATTERNS[name].shape[1]
    for nm, v in (("f", f), ("v1", v1), ("v2", v2)):
        if v % period:
            raise ValueError(f"{nm}={v} not a multiple of pattern period "
                             f"{period} for rate {name}")
