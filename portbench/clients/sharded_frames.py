"""Client of the frame-sharded decode over a node's cards:
``repro_torch.core.framed.frame_llr`` on the home card, then
``repro_torch.distributed.stream.make_sharded_frame_decoder`` over a mesh
of the cell's devices, the bits gathered back to the home card.

One call decodes one block of the pool, which lives on the home card.
"""
from __future__ import annotations

import torch
from repro_torch.core import framed
from repro_torch.core.framed import FrameSpec
from repro_torch.distributed import stream as dstream

from portbench.clients.make_decoder import decoder_config, wait_for

__all__ = ["Client"]


class Client:
    def __init__(self, cell, llr_pool, devices, slots, overrides=None):
        if cell.traffic["llr_home"] != "device" or \
                cell.traffic["bits_home"] != "device":
            raise ValueError("the sharded client keeps LLRs and bits on the "
                             "home card")
        self.n = cell.n
        self.spec = FrameSpec(**cell.config["frame"])
        self.decode_frames = dstream.make_sharded_frame_decoder(
            decoder_config(cell, overrides), dstream.frame_mesh(list(devices)))
        self.llr = list(llr_pool)

    def issue(self, p: int) -> torch.Tensor:
        frames = framed.frame_llr(self.llr[p], self.spec)
        return self.decode_frames(frames).reshape(-1)[:self.n]

    def finish(self, bits, slot: int) -> torch.Tensor:
        return wait_for(bits)
