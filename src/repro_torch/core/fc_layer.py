"""The paper's fully-connected layer (Algs 4/5), forward.

The blocked matmul kernel with the output stack block_n (Alg 5's Delta_O)
and the K loop's accumulator (Alg 4's private partial output); blocks from
the MatmulPlanner unless an explicit ``schedule`` is given.
"""

from __future__ import annotations

from repro_torch.core.machine import H100
from repro_torch.kernels.matmul.ops import fc_matmul
from repro_torch.plan import Schedule, ShardedSchedule, local_schedule, planner_for


def fc_layer(x, w, schedule: Schedule | ShardedSchedule | None = None):
    """x: [..., K]; w: [K, D_O].  Forward = the Alg 4/5 kernel (its plain
    version on CPU tensors)."""
    return fc_matmul(x, w, schedule=local_schedule(schedule))


def _fc_m(x_shape) -> int:
    m = 1
    for d in x_shape[:-1]:
        m *= d
    return m


def plan(x_shape, w_shape, *, in_bytes=4, machine=None) -> Schedule:
    """Plan this layer without running it: the Schedule the kernel would
    use for operands of these shapes."""
    k, n = w_shape
    return planner_for("matmul", machine or H100).plan(
        m=_fc_m(x_shape), n=n, k=k, in_bytes=in_bytes)
