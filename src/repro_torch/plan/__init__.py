"""The plan layer: Schedules, planners and the ``cuda_op`` registry."""

from repro_torch.plan.planners import (
    ConvPlanner, Im2colConvPlanner, MatmulPlanner, planner_for, round_up,
)
from repro_torch.plan.registry import CudaKernel, CudaOp, cuda_op, get_op, pad_dim
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.sharded import MeshSpec, ShardedSchedule, local_schedule

__all__ = [
    "ConvPlanner", "CudaKernel", "CudaOp", "Im2colConvPlanner", "MatmulPlanner",
    "MeshSpec", "Schedule", "ShardedSchedule", "cuda_op", "get_op",
    "local_schedule", "pad_dim", "planner_for", "round_up",
]
