"""Client of the receiver entry ``repro_torch.core.pipeline.make_decoder`` at
a punctured rate.

At set-up each block of the pool, the mother code's (n, beta) LLRs, is
punctured by the configuration's own ``puncture`` pattern (one row an
output, phase 0 at the first stage; the mask of
``reference/viterbi_punctured.py``) into the (m,) soft-symbol stream a
receiver gets, with nothing of the program. One call decodes one block:
``make_decoder(cfg)(stream, n)``, which depunctures by the program's
pattern for the configuration's rate. LLRs and bits stay in device memory.

A receiver that decodes a capture more slowly than the capture lasts on
the air falls behind the channel and cannot serve the deployment. On the
card the set-up times one call of each block, after a first call that
builds and loads what the decoder needs, and refuses a decoder that takes
longer than a capture's airtime at the configuration's ``line_rate_mbps``
on any of them. On the CPU the cell checks what is decoded, at sizes no
receiver runs, and nothing is timed.
"""
from __future__ import annotations

import time

import torch
from repro_torch.core.pipeline import make_decoder

from portbench.clients.make_decoder import decoder_config, wait_for
from portbench.reference.viterbi_punctured import keep_mask

__all__ = ["puncture", "airtime_s", "Client"]


def puncture(llr: torch.Tensor, config: dict) -> torch.Tensor:
    """(n, beta) symbols -> (m,) stream: the positions the configuration's
    pattern keeps, in the order they are sent (stage by stage, output by
    output)."""
    return llr[keep_mask(config, llr.shape[0], llr.device)]


def airtime_s(n: int, config: dict) -> float:
    """Seconds a capture of n information bits lasts on the air at the
    configuration's line rate."""
    return n / (float(config["line_rate_mbps"]) * 1e6)


class Client:
    """``issue(p)`` dispatches block p's stream and returns when
    ``make_decoder`` returns; ``finish(handle, slot)`` waits until the card
    has the bits and returns them."""

    def __init__(self, cell, llr_pool, devices, slots, overrides=None):
        if cell.traffic["llr_home"] != "device" or \
                cell.traffic["bits_home"] != "device":
            raise ValueError("the punctured client keeps LLRs and bits on "
                             "the card")
        self.n = cell.n
        dev = torch.device(devices[0])
        self.decode = make_decoder(decoder_config(cell, overrides), dev)
        self.stream = [puncture(b, cell.config) for b in llr_pool]
        if dev.type == "cuda":
            self.keep_up(airtime_s(self.n, cell.config))

    def issue(self, p: int) -> torch.Tensor:
        return self.decode(self.stream[p], self.n)

    def finish(self, bits, slot: int) -> torch.Tensor:
        return wait_for(bits)

    def keep_up(self, airtime: float) -> list:
        """Decode block 0, then time one call of each block, from the issue
        until the bits are ready. Raises where any call took longer than
        ``airtime`` seconds; returns the times."""
        self.finish(self.issue(0), 0)
        times = []
        for p in range(len(self.stream)):
            t0 = time.perf_counter()
            self.finish(self.issue(p), p)
            times.append(time.perf_counter() - t0)
        if max(times) > airtime:
            raise RuntimeError(
                f"the decoder falls behind the air: calls of "
                f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms for "
                f"captures of {self.n} bits that last {airtime * 1e3:.1f} ms")
        return times
