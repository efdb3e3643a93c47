"""The plan layer: Schedules, planners and the ``cuda_op`` registry."""

from repro_torch.plan.planners import (
    PLANNERS, AttentionPlanner, ConvDgradPlanner, ConvPlanner, ConvWgradPlanner,
    Im2colConvPlanner, MatmulDwPlanner, MatmulDxPlanner, MatmulPlanner, MoeFfnPlanner,
    Planner, ShardablePlanner, TransformerBlockPlanner, planner_for, round_up,
)
from repro_torch.plan.registry import (
    CudaKernel, CudaOp, cuda_op, get_op, pad_dim, with_reference_vjp,
)
from repro_torch.plan.schedule import Blocks, Schedule, to_roofline
from repro_torch.plan.sharded import (
    MeshSpec, P, ShardCandidate, ShardedSchedule, local_schedule, mesh_spec,
    partition_specs, validate_sharded_plan,
)

__all__ = [
    "PLANNERS", "Planner", "ShardablePlanner", "AttentionPlanner", "Blocks", "ConvDgradPlanner", "ConvPlanner", "ConvWgradPlanner",
    "CudaKernel", "CudaOp", "Im2colConvPlanner", "MatmulDwPlanner", "MatmulDxPlanner",
    "MatmulPlanner", "MeshSpec", "MoeFfnPlanner", "P", "Schedule", "ShardCandidate",
    "ShardedSchedule", "TransformerBlockPlanner", "cuda_op", "get_op", "local_schedule",
    "mesh_spec", "pad_dim", "partition_specs", "planner_for", "round_up", "to_roofline",
    "validate_sharded_plan", "with_reference_vjp",
]
