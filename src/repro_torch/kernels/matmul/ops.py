"""Public wrapper for the FC matmul kernel — a thin registration against the
plan layer.

Blocks come from :class:`repro_torch.plan.MatmulPlanner` (the paper's
capacity argument, Sec. 3.1.2: grow the output stack block_n while the
working set fits).  Operands are zero-padded to the blocks and the result
sliced back, as ``repro/kernels/matmul/ops.py`` does.
"""

from __future__ import annotations

import torch

from repro_torch.core.machine import H100, MachineModel
from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.plan import MatmulPlanner, Schedule, cuda_op, pad_dim, round_up


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


matmul_op = cuda_op(
    "matmul", planner=MatmulPlanner, shape_args=_shape_args, impl=_impl,
    kernel=matmul_kernel,
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
