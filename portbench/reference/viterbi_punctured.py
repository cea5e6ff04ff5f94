"""The plain reference decoder of a punctured code, in torch: the
benchmark's yardstick for the decoded bits of a punctured configuration.

The configuration states its puncturing as the standard gives it: under
``puncture`` a (beta, period) 0/1 pattern, one row an output of the
mother code in the order of ``generators_octal``, one column a phase of
the period, phase 0 the stream's first stage. A receiver that gets the
punctured stream puts a neutral zero LLR at every dropped position, so
this reference takes the mother code's (n, beta) LLRs, sets to zero every
position the configuration's own pattern drops, and decodes the result
with the plain decoder of ``viterbi.py``. The pattern the program uses is
so held to the standard's, not to itself.

It imports nothing but torch and the plain decoder beside it: no kernel,
table or helper of the decoder under test.
"""
from __future__ import annotations

import torch

from portbench.reference import viterbi

__all__ = ["pattern", "keep_mask", "reference_bits"]


def pattern(config: dict) -> torch.Tensor:
    """The configuration's (beta, period) puncturing pattern, checked
    against its generators and its stated rate."""
    code = config["code"]
    pat = torch.tensor(config["puncture"], dtype=torch.int64)
    beta = len(code["generators_octal"])
    if pat.ndim != 2 or pat.shape[0] != beta:
        raise ValueError(f"puncture pattern {config['puncture']} needs one "
                         f"row for each of the {beta} outputs")
    if not bool(((pat == 0) | (pat == 1)).all()):
        raise ValueError("a puncture pattern holds 0 and 1 only")
    rate = f"{pat.shape[1]}/{int(pat.sum())}"
    if rate != code["rate"]:
        raise ValueError(f"the pattern keeps {rate}, the code states rate "
                         f"{code['rate']}")
    return pat


def keep_mask(config: dict, n: int, device=None) -> torch.Tensor:
    """(n, beta) bool: True where the configuration's pattern keeps the
    stage's output, the pattern's phase 0 at stage 0."""
    pat = pattern(config).to(torch.bool)
    period = pat.shape[1]
    return pat.t().repeat(-(-n // period), 1)[:n].to(device)


def reference_bits(config: dict, llr: torch.Tensor) -> torch.Tensor:
    """The decoded bits of a punctured configuration's code and frame from
    the mother code's (n, beta) LLRs, the dropped positions set to zero."""
    code = config["code"]
    polys = tuple(int(g, 8) for g in code["generators_octal"])
    kept = torch.where(keep_mask(config, llr.shape[0], llr.device), llr,
                       torch.zeros((), dtype=llr.dtype, device=llr.device))
    return viterbi.decode(kept, int(code["k"]), polys, config["frame"])
