"""Public wrapper for the FC matmul kernel — a thin registration against the
plan layer.

Blocks come from :class:`repro_torch.plan.MatmulPlanner` (the paper's
capacity argument, Sec. 3.1.2: grow the output stack block_n while the
working set fits).  Operands are zero-padded to the blocks and the result
sliced back, as ``repro/kernels/matmul/ops.py`` does.  The registered
``sharded_impl`` executes the planner's multi-device strategies (Alg 4's
psum tree, Alg 3's ring, the batch and tp partitions) from a
:class:`repro_torch.plan.ShardedSchedule`: the specs come from the
schedule's partition, never from the call site.
"""

from __future__ import annotations

import torch

from repro_torch.core.machine import H100, MachineModel
from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.plan import MatmulPlanner, Schedule, cuda_op, pad_dim, round_up
from repro_torch.plan.sharded import partition_specs
from repro_torch.runtime import collectives as coll


def _shape_args(x, w, *, block_m=None, block_n=None, block_k=None):
    k, n = w.shape
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return dict(m=m, n=n, k=k, in_bytes=x.element_size(),
                block_m=block_m, block_n=block_n, block_k=block_k)


def _impl(x, w, *, schedule, block_m=None, block_n=None, block_k=None):
    del block_m, block_n, block_k  # consumed by the planner
    lead = x.shape[:-1]
    k, n = w.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    bm, bn, bk = (schedule.block("block_m"), schedule.block("block_n"),
                  schedule.block("block_k"))
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    x2 = pad_dim(pad_dim(x2, 0, mp), 1, kp).contiguous()
    wp = pad_dim(pad_dim(w, 0, kp), 1, np_).contiguous()
    out = matmul_kernel(x2, wp, block_m=bm, block_n=bn, block_k=bk)
    return out[:m, :n].reshape(*lead, n)


def _sharded_impl(x, w, *, schedule, mesh, block_m=None, block_n=None, block_k=None):
    """Run a ShardedSchedule's strategy; every spec is read off
    ``schedule.partition``:

      * "psum": K sharded, each rank runs the planned local layer on its
        shard (the kernel forward, the planned dX/dW backward), the private
        partial outputs merged by one psum (Alg 4's tree reduction);
      * "ring": Alg 3's ring reuse (core/ring.py) — the resident X shard
        permutes around the axis while each rank's full-K weight columns
        stay put;
      * "batch" / "tp": the planned local layer per rank — batch shards M
        (X rows) with W replicated, tp shards N (W columns) with X
        replicated; the output shards are gathered.
    """
    del block_m, block_n, block_k  # consumed by the planner
    from repro_torch.core.fc_layer import fc_layer
    from repro_torch.core.ring import ring_matmul_local

    *in_specs, out_spec = partition_specs(schedule)
    axis, local = schedule.axis, schedule.schedule
    if schedule.strategy == "psum":
        def fn(xl, wl):
            return coll.psum(fc_layer(xl, wl, local).float(), mesh, axis).to(x.dtype)
    elif schedule.strategy == "ring":
        def fn(xl, wl):
            return ring_matmul_local(xl, wl, mesh, axis, local)
    elif schedule.strategy in ("batch", "tp"):
        def fn(xl, wl):
            return fc_layer(xl, wl, local)
    else:
        raise NotImplementedError(f"matmul sharded strategy {schedule.strategy!r}")
    return coll.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
                          axis=axis)(x, w)


matmul_op = cuda_op(
    "matmul", planner=MatmulPlanner, shape_args=_shape_args, impl=_impl,
    kernel=matmul_kernel, sharded_impl=_sharded_impl,
)


def fc_matmul(
    x: torch.Tensor, w: torch.Tensor, *, schedule: Schedule | None = None,
    block_m: int | None = None, block_n: int | None = None,
    block_k: int | None = None, machine: MachineModel = H100,
) -> torch.Tensor:
    """O = X @ W via the blocked kernel; arbitrary shapes (padded).

    ``x``: [..., K]; ``w``: [K, N].  Leading dims of ``x`` are flattened
    into M.  Blocking: ``schedule`` > ``block_*`` pins > planner.  CPU
    tensors run the kernel's plain version, CUDA tensors the kernel.
    """
    return matmul_op(x, w, schedule=schedule, machine=machine,
                     block_m=block_m, block_n=block_n, block_k=block_k)
