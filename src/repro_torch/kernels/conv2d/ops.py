"""Public wrapper for the batched, strip-tiled direct conv kernel — a thin
registration against the plan layer.

Blocking comes from :class:`repro_torch.plan.ConvPlanner` (the capacity rule
behind the paper's Delta_O <= 24/12): pass nothing and the two-level argmin
picks the algorithm (direct strip kernel or im2col GEMM) and its blocks;
pass ``block_*`` or ``algorithm=`` to pin; or pass an explicit ``schedule=``.
The input is zero-padded spatially so every strip's halo rows exist, as in
``repro/kernels/conv2d/ops.py``; channels need no padding, the kernel runs
ragged channel counts as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100, MachineModel
from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.kernels.conv2d.ref import maxpool_ref
from repro_torch.plan import ConvPlanner, Schedule, cuda_op, round_up
from repro_torch.plan.sharded import partition_specs
from repro_torch.runtime import collectives as coll


def conv_out_extent(extent: int, padding: int, F: int, stride: int) -> int:
    """Output rows/cols of one spatial axis: (E + 2P - F)//S + 1 (Sec. 1.1)."""
    return (extent + 2 * padding - F) // stride + 1


def _fused_pool(H_O: int, W_O: int, pool: int) -> int:
    """Pool fuses into the kernel flush only when the output plane tiles
    evenly; otherwise bias+ReLU stay fused and the ragged pool runs as a
    tail op."""
    return pool if (pool > 1 and H_O % pool == 0 and W_O % pool == 0) else 1


def _shape_args(
    x, f, bias=None, *, stride=1, padding=0, relu=False, pool=1,
    block_do=None, block_di=None, block_h=None,
    algorithm=None, block_m=None, block_n=None, block_k=None,
):
    """Planner shapes from concrete operands (the op registry contract)."""
    B = x.shape[0] if x.ndim == 4 else 1
    H, W, d_in = x.shape[-3], x.shape[-2], x.shape[-1]
    Fk, d_out = f.shape[0], f.shape[3]
    H_O = conv_out_extent(H, padding, Fk, stride)
    W_O = conv_out_extent(W, padding, Fk, stride)
    return dict(
        H_O=H_O, W_O=W_O, F=Fk, S=stride, d_in=d_in, d_out=d_out,
        in_bytes=x.element_size(), block_di=block_di,
        pool=_fused_pool(H_O, W_O, pool), batch=B,
        padding=padding, H_I=H, W_I=W,
        block_h=block_h, block_do=block_do,
        algorithm=algorithm, block_m=block_m, block_n=block_n,
        block_k=block_k,
    )


def _conv2d_impl(x, f, bias, *, stride, padding, relu, pool, schedule,
                 emit_mask=False):
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    B, H, W, d_in = x.shape
    Fk = f.shape[0]
    S = stride
    H_O = conv_out_extent(H, padding, Fk, S)
    W_O = conv_out_extent(W, padding, Fk, S)
    if H_O <= 0 or W_O <= 0:
        raise ValueError("receptive field larger than padded input")
    fused_pool = _fused_pool(H_O, W_O, pool)
    if emit_mask and pool > 1 and fused_pool == 1:
        raise ValueError("ragged pool cannot emit the epilogue mask")

    bdi = schedule.block("block_di")
    bdo = schedule.block("block_do")
    hb = round_up(min(schedule.block("block_h"), round_up(H_O, fused_pool)),
                  fused_pool)
    n_h = -(-H_O // hb)
    rows_needed = (n_h * hb - 1) * S + Fk
    pad_bottom = padding + max(0, rows_needed - (H + 2 * padding))
    xp = F.pad(x, (0, 0, padding, padding, padding, pad_bottom)).contiguous()

    out = conv2d_kernel(
        xp, f.contiguous(), bias.float().contiguous(),
        stride=S, block_h=hb, block_do=bdo, block_di=bdi, H_O=H_O, W_O=W_O,
        relu=relu, pool=fused_pool, emit_mask=emit_mask,
    )
    if emit_mask:
        out, mask = out
        out, mask = out[:, : H_O // fused_pool], mask[:, : H_O // fused_pool]
        return (out, mask) if batched else (out[0], mask[0])
    out = out[:, : H_O // fused_pool]
    if pool > 1 and fused_pool == 1:  # ragged tail pool (odd H_O/W_O)
        out = maxpool_ref(out, pool)
    return out if batched else out[0]


def _local_impl(x, f, bias, *, schedule, **kw):
    """Algorithm dispatch off the schedule tag: ``algorithm="im2col"`` runs
    the patch-matrix GEMM on the matmul kernel; everything else the direct
    strip kernel."""
    if schedule.algorithm == "im2col":
        from repro_torch.kernels.conv2d.im2col import _conv2d_im2col_impl

        return _conv2d_im2col_impl(x, f, bias, schedule=schedule, **kw)
    return _conv2d_impl(x, f, bias, schedule=schedule, **kw)


def _impl(
    x, f, bias, *, schedule, stride=1, padding=0, relu=False, pool=1,
    block_do=None, block_di=None, block_h=None,  # consumed by the planner
    algorithm=None, block_m=None, block_n=None, block_k=None,
):
    del block_do, block_di, block_h, algorithm, block_m, block_n, block_k
    return _local_impl(x, f, bias, stride=stride, padding=padding, relu=relu,
                       pool=int(pool), schedule=schedule)


def _sharded_impl(
    x, f, bias, *, schedule, mesh, stride=1, padding=0, relu=False, pool=1,
    block_do=None, block_di=None, block_h=None,
    algorithm=None, block_m=None, block_n=None, block_k=None,
):
    """Data-parallel conv from a ShardedSchedule: "batch" shards images,
    "stack" shards output channels, each rank running the planned local
    kernel on its shard; no interconnect words either way.  The specs come
    from ``schedule.partition``, the blocking (and the algorithm tag) from
    the per-device local Schedule, so both partitions apply to both
    algorithm families."""
    del block_do, block_di, block_h, algorithm, block_m, block_n, block_k
    if schedule.strategy not in ("batch", "stack"):
        raise NotImplementedError(f"conv2d sharded strategy {schedule.strategy!r}")
    *in_specs, out_spec = partition_specs(schedule)
    batched = x.ndim == 4
    if not batched:
        x = x[None]

    def fn(xl, fl, bl):
        return _local_impl(xl, fl, bl, stride=stride, padding=padding, relu=relu,
                           pool=int(pool), schedule=schedule.schedule)

    out = coll.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
                         axis=schedule.axis)(x, f, bias)
    return out if batched else out[0]


conv2d_op = cuda_op(
    "conv2d", planner=ConvPlanner, shape_args=_shape_args, impl=_impl,
    kernel=conv2d_kernel, sharded_impl=_sharded_impl,
)


def _zero_bias(f: torch.Tensor) -> torch.Tensor:
    return torch.zeros(f.shape[3], dtype=torch.float32, device=f.device)


def conv2d(
    x: torch.Tensor, f: torch.Tensor, *, stride: int = 1, padding: int = 0,
    bias: torch.Tensor | None = None, relu: bool = False, pool: int | None = None,
    schedule: Schedule | None = None, block_do: int | None = None,
    block_di: int | None = None, block_h: int | None = None,
    algorithm: str | None = None, block_m: int | None = None,
    block_n: int | None = None, block_k: int | None = None,
    machine: MachineModel = H100,
) -> torch.Tensor:
    """Convolutional layer forward (paper Algs 1/2) for arbitrary shapes.

    ``x``: [H, W, D_I] or [B, H, W, D_I]; ``f``: [F, F, D_I, D_O].  One
    launch serves the whole batch; any stride runs in the kernel.
    ``bias`` ([D_O]), ``relu`` and ``pool`` (2 = fused 2x2 max-pool) run in
    the kernel's flush.  Blocking: ``schedule`` > ``block_*`` pins >
    planner.  When the im2col family wins (or ``algorithm="im2col"`` pins
    it) the call runs the patch-matrix GEMM instead.
    """
    if bias is None:
        bias = _zero_bias(f)
    return conv2d_op(
        x, f, bias, schedule=schedule, machine=machine,
        stride=stride, padding=padding, relu=relu, pool=int(pool or 1),
        block_do=block_do, block_di=block_di, block_h=block_h,
        algorithm=algorithm, block_m=block_m, block_n=block_n, block_k=block_k,
    )


def conv2d_with_mask(
    x: torch.Tensor, f: torch.Tensor, *, bias: torch.Tensor | None = None,
    stride: int = 1, padding: int = 0, pool: int = 1,
    schedule: Schedule | None = None, machine: MachineModel = H100,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Conv + ReLU (+ fused pool) that also emits the int8 epilogue mask
    (pool-argmax position, pool^2 for a dead window, or the ReLU liveness
    bit when ``pool == 1``).  Returns ``(out, None)`` on the paths the strip
    kernel's flush can't serve: an im2col schedule and the ragged-pool
    tail."""
    pool = int(pool or 1)
    if bias is None:
        bias = _zero_bias(f)
    Fk = f.shape[0]
    H_O = conv_out_extent(x.shape[-3], padding, Fk, stride)
    W_O = conv_out_extent(x.shape[-2], padding, Fk, stride)
    if schedule is None:
        schedule = conv2d_op.plan(x, f, bias, machine=machine, stride=stride,
                                  padding=padding, relu=True, pool=pool)
    ragged = pool > 1 and _fused_pool(H_O, W_O, pool) == 1
    if ragged or schedule.algorithm == "im2col":
        out = conv2d(x, f, bias=bias, stride=stride, padding=padding, relu=True,
                     pool=pool, schedule=schedule, machine=machine)
        return out, None
    return _conv2d_impl(x, f, bias, stride=stride, padding=padding, relu=True,
                        pool=pool, schedule=schedule, emit_mask=True)
