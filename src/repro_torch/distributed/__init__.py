"""Sharding across devices: port of ``repro.distributed``. The LM
scaffold's sharding rules and DTensor placements (``sharding``), the
activation context (``ctx``), int8-compressed data parallelism
(``compress``), and the frame-sharded Viterbi decode (``stream``)."""
from .sharding import (param_specs, param_shardings, batch_specs,  # noqa: F401
                       cache_specs, moment_specs)
from . import compress                                    # noqa: F401
from .stream import (FrameMesh, frame_mesh,  # noqa: F401
                     make_sharded_frame_decoder)

__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "moment_specs", "compress", "FrameMesh", "frame_mesh",
           "make_sharded_frame_decoder"]
