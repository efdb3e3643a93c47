"""repro_torch.serve — planned inference serving on one device.

The autotune cache as a serving artifact: a :class:`BucketLadder` of
pre-planned (batch, seq) shapes resolved once at warmup, a continuous-
batching :class:`Engine` over a KV slot pool, and a load generator with a
deterministic modeled-time mode.
"""

from repro_torch.serve.bucket import Bucket, BucketLadder, bucket_cells
from repro_torch.serve.engine import (
    ACTIVE,
    DONE,
    QUEUED,
    SHED,
    TIMEOUT,
    Engine,
    Request,
    RequestQueue,
    StepInfo,
    VirtualClock,
    WallClock,
)
from repro_torch.serve.loadgen import LoadReport, LoadSpec, make_requests, run_load

__all__ = [
    "Bucket", "BucketLadder", "bucket_cells",
    "Engine", "Request", "RequestQueue", "StepInfo",
    "VirtualClock", "WallClock",
    "QUEUED", "ACTIVE", "DONE", "SHED", "TIMEOUT",
    "LoadSpec", "LoadReport", "make_requests", "run_load",
]
