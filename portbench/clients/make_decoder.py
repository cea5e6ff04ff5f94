"""Client of the receiver entry ``repro_torch.core.pipeline.make_decoder``.

One call decodes one block of the pool: (n, beta) LLRs in, n bits out.
The traffic's ``llr_home`` says where the LLRs wait (``device`` memory or
pinned ``host`` buffers, which ``make_decoder`` copies in), and
``bits_home`` where the client needs the bits: on the device (the call is
done when the card has them) or in a pinned host buffer (done when they
are copied there).
"""
from __future__ import annotations

import torch
from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.trellis import make_trellis

__all__ = ["decoder_config", "Client"]


def decoder_config(cell, overrides=None) -> DecoderConfig:
    """The configuration's decoder, with ``overrides`` (say, the control's
    ``bm_dtype``) laid over its ``decoder`` settings. ``DecoderConfig``'s
    ``rate`` names a puncturing of the mother code, and "1/2" is none,
    whatever the mother code's beta."""
    k, polys, beta = cell.code
    rate = cell.config["code"]["rate"]
    knobs = {**cell.config["decoder"], **(overrides or {})}
    return DecoderConfig(trellis=make_trellis(k, polys),
                         spec=FrameSpec(**cell.config["frame"]),
                         rate="1/2" if rate == f"1/{beta}" else rate, **knobs)


def wait_for(bits: torch.Tensor) -> torch.Tensor:
    """Block the host until ``bits`` are computed on their device."""
    if bits.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(bits.device))
        done.synchronize()
    return bits


class Client:
    """``issue(p)`` dispatches block p and returns when ``make_decoder``
    returns; ``finish(handle, slot)`` waits until the bits are where the
    client needs them (host buffer ``slot`` of ``slots``) and returns
    them."""

    def __init__(self, cell, llr_pool, devices, slots, overrides=None):
        dev = torch.device(devices[0])
        self.n = cell.n
        self.decode = make_decoder(decoder_config(cell, overrides), dev)
        pin = dev.type == "cuda"
        if cell.traffic["llr_home"] == "host":
            self.llr = [b.cpu().pin_memory() if pin else b.cpu()
                        for b in llr_pool]
        else:
            self.llr = list(llr_pool)
        self.out = None
        if cell.traffic["bits_home"] == "host":
            self.out = [torch.empty(self.n, dtype=torch.int32, pin_memory=pin)
                        for _ in range(slots)]

    def issue(self, p: int):
        return self.decode(self.llr[p], self.n)

    def finish(self, bits, slot: int) -> torch.Tensor:
        if self.out is None:
            return wait_for(bits)
        return self.out[slot].copy_(bits)
