"""Hardware constants and the production mesh: port of
``repro.launch.mesh`` for NVIDIA H100 nodes.

A function, not a module-level constant, builds the mesh, so importing
this module touches no CUDA state.
"""
from __future__ import annotations

from ..distributed.stream import FrameMesh, frame_mesh

__all__ = ["make_production_mesh", "HW"]


def make_production_mesh() -> FrameMesh:
    """The frame mesh over every card of the node (distributed/stream.py);
    raises without a card."""
    return frame_mesh()


class HW:
    """NVIDIA H100 SXM5 data-sheet figures, per card (dense rates, no
    sparsity, at the 700 W power limit)."""
    HBM_BW = 3.35e12                # B/s, HBM3
    PEAK_F32_OPS = 67e12            # float32 op/s outside the tensor cores
    PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
    HBM_BYTES = 80e9                # HBM3 capacity
    NVLINK_BW = 450e9               # B/s each way (NVLink 4, 18 links)
    NET_BW = 50e9                   # B/s each way across nodes: one 400 Gb/s
                                    # NDR ConnectX-7 per GPU (DGX H100)
    SMS = 132                       # streaming multiprocessors
