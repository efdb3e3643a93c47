"""repro_torch.serve — planned inference serving.

The autotune cache as a serving artifact: a :class:`BucketLadder` of
pre-planned (batch, seq) shapes resolved once at warmup (on a mesh, to
ShardedSchedules), a continuous-batching :class:`Engine` over a KV slot
pool on one device, and a load generator with a deterministic
modeled-time mode.  The step builders of ``runtime/serve.py`` serve on a
mesh; the engine does not yet.
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
