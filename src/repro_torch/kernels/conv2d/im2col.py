"""im2col-GEMM conv2d: the direct strip kernel's rival algorithm family.

Each strip of ``block_h`` output rows expands its receptive fields into a
patch matrix of ``[batch * rows * W_O, F*F*d_in]`` with plain PyTorch
slicing — strip at a time, like the XLA code of
``repro/kernels/conv2d/im2col.py`` — and multiplies it by the reshaped
``[F*F*d_in, d_out]`` filter matrix on the blocked matmul kernel, whose
blocking :class:`repro_torch.plan.Im2colConvPlanner` delegates to
``MatmulPlanner``.  The GEMM writes f32 (bf16 patches against the f32
filter matrix on the bf16 route); bias, ReLU and pool run unfused on it and
the result is rounded once to x's dtype, as in the reference.  On a mesh
the op's ``sharded_impl`` runs the "batch" and "stack" partitions, each
rank its shard's GEMMs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100, MachineModel
from repro_torch.kernels.conv2d.ops import _fused_pool, _zero_bias, conv_out_extent
from repro_torch.kernels.conv2d.ref import maxpool_ref
from repro_torch.kernels.matmul.matmul import matmul_kernel, unrounded_dtype
from repro_torch.plan import Im2colConvPlanner, Schedule, cuda_op, pad_dim, round_up
from repro_torch.plan.sharded import partition_specs
from repro_torch.runtime import collectives as coll


def _shape_args(x, f, bias=None, *, stride=1, padding=0, relu=False, pool=1,
                block_h=None, block_m=None, block_n=None, block_k=None, out_dtype=None):
    """Planner shapes from concrete operands (the op registry contract)."""
    B = x.shape[0] if x.ndim == 4 else 1
    H, W, d_in = x.shape[-3], x.shape[-2], x.shape[-1]
    Fk, d_out = f.shape[0], f.shape[3]
    H_O = conv_out_extent(H, padding, Fk, stride)
    W_O = conv_out_extent(W, padding, Fk, stride)
    return dict(
        H_O=H_O, W_O=W_O, F=Fk, S=stride, d_in=d_in, d_out=d_out,
        in_bytes=x.element_size(), pool=_fused_pool(H_O, W_O, pool), batch=B,
        padding=padding, H_I=H, W_I=W,
        block_h=block_h, block_m=block_m, block_n=block_n, block_k=block_k,
    )


def strip_patches(xp: torch.Tensor, h0: int, rows: int, *, F: int, S: int,
                  W_O: int) -> torch.Tensor:
    """The patch matrix of one strip, ``[B * rows * W_O, F*F*d_in]`` with
    (fy, fx, d_i) column order, from the spatially padded input."""
    B, d_in = xp.shape[0], xp.shape[3]
    win = xp[:, h0 * S: h0 * S + (rows - 1) * S + F]
    cols = [win[:, fy: fy + (rows - 1) * S + 1: S, fx: fx + (W_O - 1) * S + 1: S]
            for fy in range(F) for fx in range(F)]
    return torch.stack(cols, dim=3).reshape(B * rows * W_O, F * F * d_in)


def _conv2d_im2col_impl(x, f, bias, *, stride, padding, relu, pool, schedule,
                        out_dtype=None):
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    B, H, W, d_in = x.shape
    Fk, d_out = f.shape[0], f.shape[3]
    S = stride
    H_O = conv_out_extent(H, padding, Fk, S)
    W_O = conv_out_extent(W, padding, Fk, S)
    if H_O <= 0 or W_O <= 0:
        raise ValueError("receptive field larger than padded input")

    hb = max(1, min(schedule.block("block_h"), H_O))
    k = Fk * Fk * d_in
    bm, bn, bk = (schedule.block("block_m"), schedule.block("block_n"),
                  schedule.block("block_k"))
    # Pad so every strip's halo'd window and the right-most column exist.
    n_h = -(-H_O // hb)
    pad_bottom = padding + max(0, (n_h * hb - 1) * S + Fk - (H + 2 * padding))
    pad_right = padding + max(0, (W_O - 1) * S + Fk - (W + 2 * padding))
    xp = F.pad(x, (0, 0, padding, pad_right, padding, pad_bottom))

    kp, np_ = round_up(k, bk), round_up(d_out, bn)
    wmat = pad_dim(pad_dim(f.reshape(k, d_out), 0, kp), 1, np_).contiguous()

    strips = []
    for h0 in range(0, H_O, hb):
        rows = min(hb, H_O - h0)
        a = strip_patches(xp, h0, rows, F=Fk, S=S, W_O=W_O)
        m = a.shape[0]
        ap = pad_dim(pad_dim(a, 0, round_up(m, bm)), 1, kp).contiguous()
        o = matmul_kernel(ap, wmat, block_m=bm, block_n=bn, block_k=bk,
                          out_dtype=unrounded_dtype(ap.dtype))
        strips.append(o[:m, :d_out].reshape(B, rows, W_O, d_out))
    out = torch.cat(strips, dim=1) + bias.float()
    if relu:
        out = torch.relu(out)
    if pool > 1:  # unfused epilogue (the direct kernel fuses this)
        out = maxpool_ref(out, pool)
    out = out.to(out_dtype or x.dtype)
    return out if batched else out[0]


def _impl(x, f, bias, *, schedule, stride=1, padding=0, relu=False, pool=1,
          block_h=None, block_m=None, block_n=None, block_k=None, out_dtype=None):
    del block_h, block_m, block_n, block_k  # consumed by the planner
    return _conv2d_im2col_impl(x, f, bias, stride=stride, padding=padding,
                               relu=relu, pool=int(pool), schedule=schedule,
                               out_dtype=out_dtype)


def _sharded_impl(x, f, bias, *, schedule, mesh, stride=1, padding=0, relu=False,
                  pool=1, block_h=None, block_m=None, block_n=None, block_k=None,
                  out_dtype=None):
    """Data-parallel im2col conv from a ShardedSchedule: the same
    "batch"/"stack" partitions as the direct op (each rank runs the
    planned per-shard GEMM schedule on its shard), specs from
    ``schedule.partition``."""
    del block_h, block_m, block_n, block_k  # consumed by the planner
    if schedule.strategy not in ("batch", "stack"):
        raise NotImplementedError(
            f"conv2d_im2col sharded strategy {schedule.strategy!r}")
    *in_specs, out_spec = partition_specs(schedule)
    batched = x.ndim == 4
    if not batched:
        x = x[None]

    def fn(xl, fl, bl):
        return _conv2d_im2col_impl(xl, fl, bl, stride=stride, padding=padding, relu=relu,
                                   pool=int(pool), schedule=schedule.schedule,
                                   out_dtype=out_dtype)

    out = coll.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
                         axis=schedule.axis)(x, f, bias)
    return out if batched else out[0]


conv2d_im2col_op = cuda_op(
    "conv2d_im2col", planner=Im2colConvPlanner, shape_args=_shape_args,
    impl=_impl, kernel=matmul_kernel, sharded_impl=_sharded_impl,
)


def conv2d_im2col(
    x: torch.Tensor, f: torch.Tensor, *, stride: int = 1, padding: int = 0,
    bias: torch.Tensor | None = None, relu: bool = False, pool: int | None = None,
    schedule: Schedule | None = None, block_h: int | None = None,
    block_m: int | None = None, block_n: int | None = None,
    block_k: int | None = None, machine: MachineModel = H100,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """im2col-GEMM convolutional forward for arbitrary shapes: the contract
    of :func:`repro_torch.kernels.conv2d.ops.conv2d` (fused bias/ReLU,
    unfused pool), executed as per-strip patch-matrix GEMMs."""
    if bias is None:
        bias = _zero_bias(f)
    return conv2d_im2col_op(
        x, f, bias, schedule=schedule, machine=machine,
        stride=stride, padding=padding, relu=relu, pool=int(pool or 1),
        block_h=block_h, block_m=block_m, block_n=block_n, block_k=block_k,
        out_dtype=out_dtype,
    )
