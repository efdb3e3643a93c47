"""The plan layer: Schedules, planners and the ``cuda_op`` registry."""

from repro_torch.plan.planners import (
    AttentionPlanner, ConvDgradPlanner, ConvPlanner, ConvWgradPlanner, Im2colConvPlanner,
    MatmulDwPlanner, MatmulDxPlanner, MatmulPlanner, MoeFfnPlanner, TransformerBlockPlanner,
    planner_for, round_up,
)
from repro_torch.plan.registry import (
    CudaKernel, CudaOp, cuda_op, get_op, pad_dim, with_reference_vjp,
)
from repro_torch.plan.schedule import Blocks, Schedule, to_roofline
from repro_torch.plan.sharded import MeshSpec, ShardedSchedule, local_schedule

__all__ = [
    "AttentionPlanner", "Blocks", "ConvDgradPlanner", "ConvPlanner", "ConvWgradPlanner",
    "CudaKernel", "CudaOp", "Im2colConvPlanner", "MatmulDwPlanner", "MatmulDxPlanner",
    "MatmulPlanner", "MeshSpec", "MoeFfnPlanner", "Schedule", "ShardedSchedule", "TransformerBlockPlanner",
    "cuda_op", "get_op", "local_schedule", "pad_dim", "planner_for", "round_up",
    "to_roofline", "with_reference_vjp",
]
