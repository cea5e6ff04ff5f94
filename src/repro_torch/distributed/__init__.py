"""Frame-sharded decode across devices: port of ``repro.distributed``
(its Viterbi part; the LM sharding helpers come with the LM scaffold)."""
from .stream import (FrameMesh, frame_mesh,  # noqa: F401
                     make_sharded_frame_decoder)

__all__ = ["FrameMesh", "frame_mesh", "make_sharded_frame_decoder"]
