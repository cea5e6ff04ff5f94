"""LLR input hardening: NaN/Inf scrub and out-of-range clamp; port of
``repro.core.sanitize``.

A non-finite soft symbol carries no information, so it becomes the neutral
zero LLR (as a depunctured erasure does), and finite outliers clamp to
``±clip``, keeping their sign. ``sanitize_llr`` is the host-side filter;
``make_decoder`` applies the same rule on the device. Both are the
identity on clean inputs.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LLR_CLIP", "sanitize_llr"]

#: Default magnitude clamp: far beyond any sane LLR, small enough that a
#: decode window of clamped symbols stays far inside the float32 range.
LLR_CLIP = 1e6


def sanitize_llr(llr, clip: float = LLR_CLIP,
                 policy: str = "zero") -> tuple[np.ndarray, int]:
    """Scrub an LLR buffer; returns ``(clean, n_bad)``.

    policy='zero'  : NaN/Inf -> 0.0, |x| > clip -> ±clip. Returns the
                     input array itself when n_bad == 0.
    policy='raise' : raise ValueError on the first poisoned buffer.
    policy='off'   : no scan; returns (asarray(llr), 0).
    """
    arr = np.asarray(llr, np.float32)
    if policy == "off":
        return arr, 0
    if policy not in ("zero", "raise"):
        raise ValueError(f"sanitize policy must be 'zero', 'raise' or "
                         f"'off', got {policy!r}")
    finite = np.isfinite(arr)
    bad = ~finite | (np.abs(arr) > clip)
    n_bad = int(bad.sum())
    if n_bad == 0:
        return arr, 0
    if policy == "raise":
        raise ValueError(
            f"{n_bad} non-finite or out-of-range (|llr| > {clip:g}) "
            f"values in a push of {arr.size}")
    out = np.where(finite, np.clip(arr, -clip, clip), np.float32(0.0))
    return out.astype(np.float32, copy=False), n_bad
