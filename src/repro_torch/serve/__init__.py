"""Multi-tenant Viterbi decode service (continuous batching for
receivers); port of ``repro.serve``.

``DecodeServer`` aggregates many independent, heterogeneous LLR streams
into the large frame batches where the CUDA kernels' throughput lives;
``plan_cache.PLAN_CACHE`` is the process-global decode-program cache
shared with the stream and pipeline layers.
"""
from .plan_cache import PLAN_CACHE, PlanCache          # noqa: F401
from .metrics import BucketMetrics, ServeMetrics, FAULT_COUNTERS  # noqa: F401
from .scheduler import Breaker, Bucket, Session, bucket_plan    # noqa: F401
from .server import (Backpressure, DecodeServer, Draining,  # noqa: F401
                     LaunchTimeout, PoisonedInput, ServeError, ServerFull,
                     SessionQuarantined)
from .checkpoint import (CheckpointError, load_checkpoint,  # noqa: F401
                         save_checkpoint)

__all__ = ["DecodeServer", "ServeError", "ServerFull", "Backpressure",
           "PoisonedInput", "SessionQuarantined", "LaunchTimeout",
           "Draining", "CheckpointError", "save_checkpoint",
           "load_checkpoint", "PlanCache", "PLAN_CACHE", "ServeMetrics",
           "BucketMetrics", "FAULT_COUNTERS", "Breaker", "Bucket",
           "Session", "bucket_plan"]
