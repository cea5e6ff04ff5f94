"""A plain framed Viterbi decoder, in torch: the benchmark's yardstick for
the decoded bits.

It decodes a (n, beta) LLR stream the way a framed, parallel-traceback
receiver defines the result (the paper's Fig. 2 and §IV-E):

1. Framing. The stream is cut into F = ceil(n / f) frames. Frame m keeps
   stages [m f, (m + 1) f) and runs over [m f - v1, m f + f + v2): v1
   warm-up stages and v2 convergence stages, zero LLRs past either end.
2. Recursion, per frame, from all-zero path metrics. The branch metric of
   an edge whose output bits are o_0 .. o_{beta-1} is the float32 sum, in
   order b = 0, 1, ..., of (1 - 2 o_b) * llr_b. State j (k - 1 bits, the
   newest input in the most significant bit) is reached from 2j mod S and
   2j + 1 mod S with input bit j >> (k - 2); the candidate through
   2j + 1 wins ties. The new metrics have their maximum subtracted at
   every stage, and the stage's survivor start is the first state that
   holds the maximum.
3. Traceback, in f / f0 subframes of f0 kept stages: subframe q starts at
   stage e = v1 + (q + 1) f0 - 1 + v2s from that stage's first maximal
   state (``start='boundary'``) or from state 0 (``'fixed'``), chases back
   f0 + v2s stages, and keeps the last f0 bits it finds. ``f0 = 0`` is one
   subframe of f stages that starts at the frame's last stage.

It imports nothing but torch: no kernel, table or helper of the decoder
under test. Frames are decoded in blocks that keep the survivors under a
byte budget, so a large code fits beside whatever else the card holds.
"""
from __future__ import annotations

import torch

__all__ = ["edge_words", "decode", "reference_bits"]


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def edge_words(k: int, polys) -> torch.Tensor:
    """(S, 2) int64: the output word of the edge from predecessor p into
    state j, poly 0 in the word's most significant bit."""
    S = 1 << (k - 1)
    words = torch.zeros((S, 2), dtype=torch.int64)
    for j in range(S):
        bit = j >> (k - 2)
        for p in (0, 1):
            pred = (2 * j + p) % S
            w = (bit << (k - 1)) | pred
            o = 0
            for g in polys:
                o = (o << 1) | _parity(int(g) & w)
            words[j, p] = o
    return words


def _branch_table(llr: torch.Tensor, beta: int) -> torch.Tensor:
    """(..., beta) LLRs -> (..., 2^beta) float32 branch metrics, summed in
    order b = 0 .. beta-1 (word bit beta-1-b holds output b)."""
    words = torch.arange(1 << beta, device=llr.device)
    acc = None
    for b in range(beta):
        sign = 1.0 - 2.0 * ((words >> (beta - 1 - b)) & 1).to(torch.float32)
        term = llr[..., b, None] * sign
        acc = term if acc is None else acc + term
    return acc


def _decode_frames(frames: torch.Tensor, k: int, words: torch.Tensor,
                   spec: dict) -> torch.Tensor:
    """(F, L, beta) frames -> (F, f) int32 kept bits."""
    F, L, beta = frames.shape
    S = 1 << (k - 1)
    dev = frames.device
    j = torch.arange(S, device=dev)
    pred = torch.stack([(2 * j) % S, (2 * j + 1) % S], dim=1)    # (S, 2)
    words = words.to(dev)
    bm = _branch_table(frames.to(torch.float32), beta)           # (F, L, 2^b)
    sigma = torch.zeros((F, S), dtype=torch.float32, device=dev)
    sel = torch.empty((F, L, S), dtype=torch.bool, device=dev)
    amax = torch.empty((F, L), dtype=torch.int64, device=dev)
    for t in range(L):
        bmt = bm[:, t, :]
        cand0 = sigma[:, pred[:, 0]] + bmt[:, words[:, 0]]
        cand1 = sigma[:, pred[:, 1]] + bmt[:, words[:, 1]]
        take1 = cand1 >= cand0
        new = torch.where(take1, cand1, cand0)
        sigma = new - new.max(dim=1, keepdim=True).values
        sel[:, t, :] = take1
        amax[:, t] = torch.argmax(sigma, dim=1)
    del bm

    f, v1, v2 = spec["f"], spec["v1"], spec["v2"]
    f0, v2s = spec.get("f0", 0), spec.get("v2s", 0)
    start = spec.get("start", "boundary")
    if f0 == 0:                      # serial: one subframe over the frame
        f0, v2s, start = f, v2, "boundary"
    nsub = f // f0
    ends = v1 + (torch.arange(nsub, device=dev) + 1) * f0 - 1 + v2s
    if start == "boundary":
        state = amax[:, ends]                                    # (F, nsub)
    elif start == "fixed":
        state = torch.zeros((F, nsub), dtype=torch.int64, device=dev)
    else:
        raise ValueError(f"unknown traceback start {start!r}")
    rows = torch.arange(F, device=dev)[:, None]
    kept = torch.empty((F, nsub, f0), dtype=torch.int32, device=dev)
    for r in range(f0 + v2s):
        stage = ends - r                                         # (nsub,)
        if r >= v2s:
            kept[:, :, f0 - 1 - (r - v2s)] = (state >> (k - 2)).to(torch.int32)
        took = sel[rows, stage[None, :], state].to(torch.int64)
        state = pred[state, took]
    return kept.reshape(F, f)


def decode(llr: torch.Tensor, k: int, polys, spec: dict,
           survivor_budget: int = 1 << 31) -> torch.Tensor:
    """(n, beta) float32 LLRs -> (n,) int32 decoded bits, on llr's device.

    ``spec`` holds the frame: f, v1, v2, f0, v2s and start. Frames are
    decoded ``survivor_budget`` bytes of survivors at a time."""
    n, beta = llr.shape
    if len(polys) != beta:
        raise ValueError(f"{len(polys)} generators for {beta} LLRs a stage")
    f, v1, v2 = spec["f"], spec["v1"], spec["v2"]
    if spec.get("f0", 0) and f % spec["f0"]:
        raise ValueError(f"f={f} is not a multiple of f0={spec['f0']}")
    if spec.get("v2s", 0) > v2:
        raise ValueError(f"v2s={spec['v2s']} exceeds v2={v2}")
    L = v1 + f + v2
    F = -(-n // f)
    padded = torch.nn.functional.pad(llr, (0, 0, v1, F * f + v2 - n))
    words = edge_words(k, polys)
    per_block = max(1, survivor_budget // (L << (k - 1)))
    out = torch.empty((F, f), dtype=torch.int32, device=llr.device)
    offs = torch.arange(L, device=llr.device)
    for lo in range(0, F, per_block):
        hi = min(F, lo + per_block)
        starts = torch.arange(lo, hi, device=llr.device) * f
        frames = padded[starts[:, None] + offs[None, :]]          # (B, L, beta)
        out[lo:hi] = _decode_frames(frames, k, words, spec)
    return out.reshape(-1)[:n]


def reference_bits(config: dict, llr: torch.Tensor) -> torch.Tensor:
    """The decoded bits of a configuration file's code and frame."""
    code = config["code"]
    polys = tuple(int(g, 8) for g in code["generators_octal"])
    if code["rate"] != f"1/{len(polys)}":
        raise ValueError(f"rate {code['rate']} is punctured; this reference "
                         f"decodes the mother code's LLRs only")
    return decode(llr, int(code["k"]), polys, config["frame"])
