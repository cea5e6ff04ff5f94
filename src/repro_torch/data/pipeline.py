"""Deterministic synthetic data pipeline; port of ``repro.data.pipeline``
(the same numpy code: batches stay numpy, the train step moves them to
the device).

Same contract a production loader would implement: per-host sharding (each
host materializes only its slice of the global batch), deterministic as a
function of (seed, step) so restarts/elastic rescales replay identically,
and double-buffered prefetch. Tokens come from a counter-based hash (no RNG
state to checkpoint — the step index IS the state, which is what makes
fault-tolerant resume trivial).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..configs.base import ModelConfig

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    mode: str = "random"       # 'random' (throughput) | 'learnable' (tests)


def _hash_tokens(seed: int, step: int, rows: np.ndarray, seq: int,
                 vocab: int, mode: str = "random") -> np.ndarray:
    """Counter-hash tokens -> (len(rows), seq). 'learnable' mode emits
    arithmetic progressions (fully predictable -> loss can reach ~0)."""
    base = ((seed * 0x9E3779B97F4A7C15 + (step + 1) * 0xBF58476D1CE4E5B9)
            % 2**64)
    if mode == "learnable":
        start = (rows[:, None].astype(np.int64) * 7 + 3) % vocab
        return ((start + np.arange(seq, dtype=np.int64)[None, :])
                % vocab).astype(np.int32)
    cols = np.arange(seq, dtype=np.uint64)[None, :]
    x = (np.uint64(base)
         + rows[:, None].astype(np.uint64) * np.uint64(0x94D049BB133111EB)
         + cols * np.uint64(0xD6E8FEB86659FD93))
    x ^= x >> np.uint64(30); x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27); x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(vocab)).astype(np.int32)


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int) -> dict:
    """The host-local slice of the global batch for ``step``."""
    per_host = dc.global_batch // dc.num_hosts
    rows = np.arange(dc.host_id * per_host, (dc.host_id + 1) * per_host,
                     dtype=np.int64)
    toks = _hash_tokens(dc.seed, step, rows, dc.seq_len + 1, cfg.vocab,
                        dc.mode)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.vision_patches:
        rs = np.random.RandomState((dc.seed * 1_000_003 + step) % 2**31)
        batch["vision_embeds"] = rs.randn(
            per_host, cfg.vision_patches, cfg.d_model).astype(np.float32)
        batch["labels"][:, :cfg.vision_patches] = -1   # don't train on patches
    if cfg.family == "encdec":
        rs = np.random.RandomState((dc.seed * 1_000_003 + step) % 2**31)
        batch["frames"] = rs.randn(per_host, dc.seq_len,
                                   cfg.d_model).astype(np.float32)
    return batch


class SyntheticLM:
    """Iterator facade with prefetch-by-construction (hash is O(batch))."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig, start_step: int = 0):
        self.cfg, self.dc, self.step = cfg, dc, start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.dc, self.step)
        self.step += 1
        return b
