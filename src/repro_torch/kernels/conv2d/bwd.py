"""The conv layer's planned backward: dgrad (input gradient) and wgrad
(filter gradient), two ops on the plan layer.

* ``conv2d_dgrad`` — dX is a *stride-1* strip conv over the S-dilated,
  (F-1-P)-padded gradient with spatially flipped, channel-swapped filters,
  so it runs the forward direct kernel (``csrc/conv2d.cu``, bias zero, no
  ReLU, no pool) on that transposed geometry.  This is what
  ``repro/kernels/conv2d/bwd.py::_dgrad_dma_kernel`` computes ("same
  operands and result as stride-1 relu/pool-free conv2d_fused_pallas");
  its d_out stream folded inside each step is the conv kernel's
  double-buffered d_in loop.  Both schedule tags ("direct",
  "fused_epilogue") run it with the same numerics.  The dilation,
  padding and filter flip are plain PyTorch around the kernel, as they are
  XLA code around the Pallas kernel in ``repro``.
* ``conv2d_wgrad`` — dW[ky, kx] accumulates X_strip^T @ dY_strip over the
  (batch, strip) sweep in ``csrc/conv2d_wgrad.cu``, which replaces
  ``_wgrad_dma_kernel`` and ``_wgrad_kernel`` (one function, two TPU
  schedules).  The sweep is split over a number of thread blocks fixed by
  the shapes (:func:`wgrad_split`) so the grid fills the card's resident
  block slots; partial f32 slabs are summed in a fixed order.  The
  launch pads both channel axes to multiples of 4
  (:func:`wgrad_channels`) for the kernel's four-element copies.

On the CNN's bf16 route dY stays bf16 (as ``repro``'s backward keeps
``dy.dtype``): dgrad runs the conv kernel's bf16-input route against the
f32 filters and writes f32, wgrad takes bf16 X and dY and writes f32; the
caller casts dX to x's dtype and dW to f's.  A bf16 dY is exactly its f32
upcast, so both equal ``repro``'s f32 sums of the same products.

Both ops take an optional ``mask``/``pool`` pair — the int8
pool-argmax/ReLU mask the forward kernel emitted.  Then ``dy`` is the
pooled cotangent and :func:`epilogue_scatter` (plain PyTorch, as it is
XLA code in ``repro``) rebuilds the full-rate gradient first.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from repro_torch.core.machine import H100, MachineModel, h100_resident_blocks
from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.plan import (
    ConvDgradPlanner, ConvWgradPlanner, Schedule, cuda_op, pad_dim,
)
from repro_torch.kernels.matmul.matmul import plain_matmul, stage_bytes, unrounded_dtype
from repro_torch.plan.registry import CudaKernel, activation_dtype

LANE = 8  # output channels of one thread item
MAX_GRID_YZ = 65535


# ---------------------------------------------------------------------------
# Fused epilogue VJP: scatter dY through the saved pool-argmax/ReLU mask
# ---------------------------------------------------------------------------


def epilogue_scatter(g: torch.Tensor, mask: torch.Tensor, pool: int) -> torch.Tensor:
    """The epilogue VJP from the saved mask: route the pooled cotangent
    ``g`` [..., Hp, Wp, C] to the argmax position of each pool window (zero
    elsewhere; the int8 mask holds the index in [0, pool^2), or pool^2 for
    a dead all-ReLU-clamped window), returning the full-rate dY
    [..., Hp*pool, Wp*pool, C] in ``g``'s dtype (a routing of its values:
    nothing rounds).  With ``pool == 1`` the mask is the ReLU liveness bit
    (0 alive, 1 dead).  Winner-take-all on exact pool-window ties, as in
    ``repro``."""
    m = mask.long()
    if pool == 1:
        return torch.where(m == 0, g, torch.zeros_like(g))
    p2 = pool * pool
    # the one-hot rows of the window positions (the dead index p2 gives a
    # zero row), made by one compare: the same ops on every device, so a
    # dry run on meta counts what the card runs
    oh = (m[..., None] == torch.arange(p2, device=m.device)).to(g.dtype)
    d = g[..., None] * oh
    *lead, hp, wp, c, _ = d.shape
    d = d.reshape(*lead, hp, wp, c, pool, pool)
    off = len(lead)
    perm = tuple(range(off)) + tuple(off + i for i in (0, 3, 1, 4, 2))
    return d.permute(perm).reshape(*lead, hp * pool, wp * pool, c)


# ---------------------------------------------------------------------------
# dgrad: dX via the forward strip kernel on the transposed geometry
# ---------------------------------------------------------------------------


def dgrad_out_extent(out: int, F: int, stride: int, padding: int) -> int:
    """Default dX extent for one axis: the exact-cover forward input
    (H_O - 1)*S + F - 2P.  A larger (ragged-stride) forward input passes
    its true extent via ``out_hw``; the kernel computes the extra (zero)
    rows too."""
    return (out - 1) * stride + F - 2 * padding


def conv2d_dgrad_ref(dy, f, *, stride: int = 1, padding: int = 0, out_hw=None):
    """Plain oracle: the gradient of :func:`conv2d_ref` with respect to its
    input (autograd of the plain conv)."""
    Fk, d_in = f.shape[0], f.shape[2]
    H_O, W_O = dy.shape[-3], dy.shape[-2]
    H_I, W_I = out_hw if out_hw is not None else (
        dgrad_out_extent(H_O, Fk, stride, padding),
        dgrad_out_extent(W_O, Fk, stride, padding))
    x0 = torch.zeros(dy.shape[:-3] + (H_I, W_I, d_in), dtype=torch.float32,
                     device=dy.device, requires_grad=True)
    with torch.enable_grad():
        y = conv2d_ref(x0, f.detach().float(), stride=stride, padding=padding)
        return torch.autograd.grad(y, x0, dy.detach().float())[0]


def dilate_crop(dy: torch.Tensor, stride: int, crop: int, out_hw, F: int) -> torch.Tensor:
    """dY [B, H_O, W_O, D_O] S-dilated and cut by ``crop`` rows and
    columns in front, to the H_I + F - 1 rows (W_I + F - 1 columns) that
    dX's ``out_hw`` = (H_I, W_I) reads: the operand of dX at padding
    P > F - 1, ``crop`` = P - (F - 1), where the transposed padding is
    negative.  An exact-cover input loses ``crop`` at each end; a ragged
    one keeps the tail row its last input rows read.  dX is then the
    stride-1 dgrad of this operand at padding F - 1 (transposed padding
    0), so the forward kernel runs it unchanged (plain PyTorch around the
    kernel, as the dilation is)."""
    B, H_O, W_O, d = dy.shape
    rows, cols = out_hw[0] + F - 1, out_hw[1] + F - 1
    H_dil, W_dil = (H_O - 1) * stride + 1, (W_O - 1) * stride + 1
    dil = dy.new_zeros((B, max(H_dil, crop + rows), max(W_dil, crop + cols), d))
    dil[:, :H_dil:stride, :W_dil:stride] = dy
    return dil[:, crop:crop + rows, crop:crop + cols].contiguous()


def _dgrad_shape_args(dy, f, *, stride=1, padding=0, out_hw=None, mask=None,
                      pool=1, block_h=None, block_do=None, block_di=None):
    """Planner shapes (forward-layer terms).  With a mask ``dy`` is the
    pooled cotangent: the full-rate extents are scaled back up and the pool
    factor rides into the planner, which then defaults to the
    fused_epilogue variant."""
    B = dy.shape[0] if dy.ndim == 4 else 1
    H_O, W_O, d_out = dy.shape[-3], dy.shape[-2], dy.shape[-1]
    if mask is not None:
        H_O, W_O = H_O * pool, W_O * pool
    H_I, W_I = out_hw if out_hw is not None else (None, None)
    return dict(
        H_O=H_O, W_O=W_O, F=f.shape[0], S=stride, P=padding,
        d_in=f.shape[2], d_out=d_out, in_bytes=dy.element_size(), batch=B,
        H_I=H_I, W_I=W_I, pool=pool if mask is not None else None,
        block_h=block_h, block_do=block_do, block_di=block_di,
    )


def dgrad_operands(dy, f, *, stride: int, padding: int, out_hw, block_h: int):
    """The conv kernel's operands for dX on the transposed geometry: the
    S-dilated, (F-1-P)-padded gradient (rows and columns for every strip's
    halo), the flipped, channel-swapped filters [F, F, D_O, D_I], a zero
    bias, and the kernel's geometry keywords (bar the channel blocks)."""
    B, H_O, W_O, d_out = dy.shape
    Fk, d_in = f.shape[0], f.shape[2]
    S, P = stride, padding
    if P > Fk - 1:
        raise ValueError(f"dgrad needs padding <= F-1, got {P} for F={Fk}")
    H_I, W_I = out_hw if out_hw is not None else (
        dgrad_out_extent(H_O, Fk, S, P), dgrad_out_extent(W_O, Fk, S, P))
    pt = Fk - 1 - P  # transposed padding
    hb = max(1, min(block_h, H_I))
    n_h = -(-H_I // hb)
    H_dil, W_dil = (H_O - 1) * S + 1, (W_O - 1) * S + 1
    rows = max(H_dil + 2 * pt, (n_h * hb - 1) + Fk)
    cols = max(W_dil + 2 * pt, (W_I - 1) + Fk)
    xp = dy.new_zeros((B, rows, cols, d_out))
    xp[:, pt:pt + H_dil:S, pt:pt + W_dil:S] = dy  # S-1 interior zeros
    ft = torch.flip(f, (0, 1)).permute(0, 1, 3, 2).contiguous()
    bias = torch.zeros(d_in, dtype=torch.float32, device=dy.device)
    return xp, ft, bias, dict(stride=1, block_h=hb, H_O=H_I, W_O=W_I, relu=False,
                              pool=1)


def _dgrad_impl(dy, f, *, schedule, stride=1, padding=0, out_hw=None, mask=None,
                pool=1, block_h=None, block_do=None, block_di=None):
    del block_h, block_do, block_di  # consumed by the planner
    batched = dy.ndim == 4
    if not batched:
        dy = dy[None]
        mask = None if mask is None else mask[None]
    if mask is not None:
        dy = epilogue_scatter(dy, mask, pool)
    xp, ft, bias, geo = dgrad_operands(dy, f, stride=stride, padding=padding,
                                       out_hw=out_hw, block_h=schedule.block("block_h"))
    out = conv2d_kernel(xp, ft, bias, block_do=schedule.block("block_do"),
                        block_di=schedule.block("block_di"),
                        out_dtype=unrounded_dtype(xp.dtype), **geo)
    dx = out[:, :geo["H_O"]]
    return dx if batched else dx[0]


dgrad_op = cuda_op("conv2d_dgrad", planner=ConvDgradPlanner,
                   shape_args=_dgrad_shape_args, impl=_dgrad_impl,
                   kernel=conv2d_kernel)


def conv2d_dgrad(
    dy: torch.Tensor, f: torch.Tensor, *, stride: int = 1, padding: int = 0,
    out_hw: tuple[int, int] | None = None, mask: torch.Tensor | None = None,
    pool: int = 1, schedule: Schedule | None = None, block_h: int | None = None,
    block_do: int | None = None, block_di: int | None = None,
    machine: MachineModel = H100,
) -> torch.Tensor:
    """Input gradient of :func:`repro_torch.kernels.conv2d.ops.conv2d`.

    ``dy``: [B, H_O, W_O, D_O] or [H_O, W_O, D_O] cotangent of the conv
    output; ``f``: [F, F, D_I, D_O] the forward filters.  ``out_hw`` =
    (H_I, W_I) of the forward input.  With ``mask``/``pool`` (the forward
    kernel's int8 epilogue residual) ``dy`` is the pooled cotangent,
    scattered to full rate first.  Blocking: ``schedule`` > ``block_*``
    pins > ConvDgradPlanner.
    """
    return dgrad_op(dy, f, schedule=schedule, machine=machine, stride=stride,
                    padding=padding, out_hw=out_hw, mask=mask, pool=pool,
                    block_h=block_h, block_do=block_do, block_di=block_di)


# ---------------------------------------------------------------------------
# wgrad: dW accumulated over the (batch, strip) sweep
# ---------------------------------------------------------------------------


def conv2d_wgrad_ref(x, dy, *, F: int, stride: int = 1, padding: int = 0):
    """Plain oracle: the gradient of :func:`conv2d_ref` with respect to its
    filters (autograd of the plain conv)."""
    f0 = torch.zeros((F, F, x.shape[-1], dy.shape[-1]), dtype=torch.float32,
                     device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = conv2d_ref(x.detach().float(), f0, stride=stride, padding=padding)
        return torch.autograd.grad(y, f0, dy.detach().float())[0]


def wgrad_smem_bytes(*, block_h: int, block_do: int, block_di: int, W_O: int,
                     F: int, S: int, in_bytes: int = 4) -> int:
    """Shared memory one wgrad block allocates: the F*F*bdi*bdo f32
    accumulator and two stages of the halo'd X strip and the dY strip at
    ``in_bytes`` an element (== ConvWgradPlanner's H100 budget term)."""
    h_halo, w_str = (block_h - 1) * S + F, (W_O - 1) * S + F
    return (4 * F * F * block_di * block_do
            + 2 * in_bytes * (h_halo * w_str * block_di + block_h * W_O * block_do))


def wgrad_supported_blocks(*, block_h: int, block_do: int, block_di: int,
                           W_O: int, F: int, S: int, in_bytes: int = 4) -> bool:
    """The blocks the wgrad kernel takes: a multiple-of-8 gradient stack
    and tiles (X and dY at ``in_bytes`` an element) that fit one block's
    shared memory."""
    return (block_do > 0 and block_do % LANE == 0 and block_di > 0 and block_h > 0
            and wgrad_smem_bytes(block_h=block_h, block_do=block_do,
                                 block_di=block_di, W_O=W_O, F=F, S=S, in_bytes=in_bytes)
            <= H100.local_mem_bytes)


def wgrad_split(*, d_in: int, d_out: int, block_di: int, block_do: int,
                batch: int, n_h: int, smem_bytes: int, units: int = H100.units) -> int:
    """Thread blocks that share each (d_i block, d_o stack)'s (batch, strip)
    sweep: as many as fill the resident block slots of the card's SMs
    (two a SM where two blocks' shared memory fits, else one), never more
    than the sweep has steps.  A function of the shapes alone, so the
    order of the partial sums (and the result) never changes."""
    pairs = -(-d_in // block_di) * -(-d_out // block_do)
    slots = h100_resident_blocks(smem_bytes) * units
    return max(1, min(batch * n_h, slots // pairs, MAX_GRID_YZ))


def wgrad_channels(d: int) -> int:
    """Channels the wgrad kernel takes for ``d``: rounded up to a multiple
    of 4, so every pixel's channel run is whole 16-byte copies (conv0's 3
    input channels run as 4; the zero channel adds nothing and its dW
    rows are sliced off)."""
    return -(-d // 4) * 4


def wgrad_pad_channels(x_pad, dy):
    """The kernel's operands with both channel axes zero-padded to
    :func:`wgrad_channels` (no copy when they already are)."""
    return (pad_dim(x_pad, -1, wgrad_channels(x_pad.shape[-1])).contiguous(),
            pad_dim(dy, -1, wgrad_channels(dy.shape[-1])).contiguous())


def wgrad_partial_bytes(*, F: int, d_in: int, d_out: int, split: int) -> int:
    """Device memory of the partial f32 dW slabs (0 when one block per
    (d_i, d_o) pair writes dW directly)."""
    return 4 * split * F * F * d_in * d_out if split > 1 else 0


def _check_wgrad(x_pad, dy, *, F, stride, block_h, block_do, block_di, H_O, W_O):
    if x_pad.ndim != 4 or dy.ndim != 4 or x_pad.shape[0] != dy.shape[0]:
        raise ValueError(f"conv2d_wgrad shapes x={tuple(x_pad.shape)} "
                         f"dy={tuple(dy.shape)}")
    B, H_in, W_in, _ = x_pad.shape
    _, H_g, W_g, _ = dy.shape
    in_bytes = stage_bytes(activation_dtype("conv2d_wgrad", x=x_pad, dy=dy))
    if not wgrad_supported_blocks(block_h=block_h, block_do=block_do,
                                  block_di=block_di, W_O=W_O, F=F, S=stride,
                                  in_bytes=in_bytes):
        raise ValueError(f"conv2d_wgrad kernel does not take blocks (h={block_h}, "
                         f"do={block_do}, di={block_di}) at W_O={W_O}, F={F}, "
                         f"S={stride}")
    n_h = -(-H_O // block_h)
    if W_g != W_O or H_g != n_h * block_h:
        raise ValueError(f"conv2d_wgrad dy {tuple(dy.shape)} is not {n_h} strips "
                         f"of {block_h} rows x {W_O} cols")
    if H_in < (n_h * block_h - 1) * stride + F or W_in < (W_O - 1) * stride + F:
        raise ValueError(f"conv2d_wgrad input {H_in}x{W_in} does not cover {n_h} "
                         f"strips of {block_h} rows x {W_O} cols")
    return B, n_h


def conv2d_wgrad_plain(x_pad, dy, *, F: int, stride: int, block_h: int,
                       block_do: int, block_di: int, H_O: int, W_O: int):
    """The wgrad kernel's function in plain PyTorch (same contract, same
    checks): dW[ky, kx] = window(ky, kx)^T @ dY over every (image, strip)
    row, one matmul per filter tap; bf16 operands multiplied in f32 (dW is
    f32).  On the card it needs TF32 off to be an f32 reference."""
    B, n_h = _check_wgrad(x_pad, dy, F=F, stride=stride, block_h=block_h,
                          block_do=block_do, block_di=block_di, H_O=H_O, W_O=W_O)
    rows, S = n_h * block_h, stride
    g = dy.reshape(-1, dy.shape[-1])
    taps = [plain_matmul(x_pad[:, ky: ky + (rows - 1) * S + 1: S,
                               kx: kx + (W_O - 1) * S + 1: S]
                         .reshape(-1, x_pad.shape[-1]).t(), g)
            for ky in range(F) for kx in range(F)]
    return torch.stack(taps).reshape(F, F, x_pad.shape[-1], dy.shape[-1])


def conv2d_wgrad_cost(x_pad, dy, *, F: int, stride: int, block_h: int,
                      block_do: int, block_di: int, H_O: int,
                      W_O: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: 2 FLOP a tap and channel pair at every
    output pixel; x and dY read once, dW written once."""
    del stride, block_h, block_do, block_di
    B, d_in, d_out = x_pad.shape[0], x_pad.shape[-1], dy.shape[-1]
    nbytes = (x_pad.numel() * x_pad.element_size() + dy.numel() * dy.element_size()
              + 4 * F * F * d_in * d_out)
    return 2.0 * B * H_O * W_O * F * F * d_in * d_out, float(nbytes)


def _launch_wgrad(kernel: CudaKernel, x_pad, dy, *, F: int, stride: int,
                  block_h: int, block_do: int, block_di: int, H_O: int, W_O: int):
    B, n_h = _check_wgrad(x_pad, dy, F=F, stride=stride, block_h=block_h,
                          block_do=block_do, block_di=block_di, H_O=H_O, W_O=W_O)
    d_in, d_out = x_pad.shape[-1], dy.shape[-1]
    if -(-d_out // block_do) > MAX_GRID_YZ:
        raise ValueError(f"conv2d_wgrad: {d_out} channels over stacks of {block_do} "
                         "exceed the grid")
    xk, gk = wgrad_pad_channels(x_pad, dy)
    route = kernel.operand_dtype(x=xk, dy=gk)
    _, H_in, W_in, d_ik = xk.shape
    d_ok = gk.shape[-1]
    split = wgrad_split(d_in=d_ik, d_out=d_ok, block_di=block_di, block_do=block_do,
                        batch=B, n_h=n_h,
                        smem_bytes=wgrad_smem_bytes(block_h=block_h, block_do=block_do,
                                                    block_di=block_di, W_O=W_O, F=F,
                                                    S=stride, in_bytes=xk.element_size()))
    out = torch.empty((F, F, d_ik, d_ok), dtype=torch.float32, device=x_pad.device)
    part = (torch.empty((split, F, F, d_ik, d_ok), dtype=torch.float32,
                        device=x_pad.device) if split > 1 else None)
    kernel.run(ctypes.c_void_p(xk.data_ptr()), ctypes.c_void_p(gk.data_ptr()),
               ctypes.c_void_p(out.data_ptr()),
               ctypes.c_void_p(part.data_ptr() if part is not None else None),
               B, H_in, W_in, d_ik, d_ok, F, stride, W_O, n_h, block_h,
               block_di, block_do, split, dtype=route)
    if (d_ik, d_ok) != (d_in, d_out):
        out = out[:, :, :d_in, :d_out].contiguous()
    return out


conv2d_wgrad_kernel = CudaKernel(
    "conv2d_wgrad", source="conv2d_wgrad", symbol="repro_conv2d_wgrad_f32",
    bf16_symbol="repro_conv2d_wgrad_bf16",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
    launch=_launch_wgrad, plain=conv2d_wgrad_plain, cost=conv2d_wgrad_cost,
)


def _wgrad_shape_args(x, dy, *, F, stride=1, padding=0, mask=None, pool=1,
                      block_h=None, block_do=None, block_di=None):
    B = x.shape[0] if x.ndim == 4 else 1
    H, W, d_in = x.shape[-3], x.shape[-2], x.shape[-1]
    H_O, W_O, d_out = dy.shape[-3], dy.shape[-2], dy.shape[-1]
    if mask is not None:  # dy is the pooled cotangent
        H_O, W_O = H_O * pool, W_O * pool
    return dict(
        H_O=H_O, W_O=W_O, F=F, S=stride, d_in=d_in, d_out=d_out,
        in_bytes=x.element_size(), batch=B, padding=padding, H_I=H, W_I=W,
        block_h=block_h, block_do=block_do, block_di=block_di,
    )


def wgrad_operands(x, dy, *, F: int, stride: int, padding: int, block_h: int):
    """The wgrad kernel's operands: the spatially padded input (rows for
    every strip's halo), the gradient padded with zero rows to whole
    strips, and the kernel's geometry keywords (bar the channel blocks)."""
    _, H, _, _ = x.shape
    _, H_O, W_O, _ = dy.shape
    S, P = stride, padding
    hb = max(1, min(block_h, H_O))
    n_h = -(-H_O // hb)
    pad_bottom = P + max(0, (n_h * hb - 1) * S + F - (H + 2 * P))
    xp = nnf.pad(x, (0, 0, P, P, P, pad_bottom)).contiguous()
    gp = nnf.pad(dy, (0, 0, 0, 0, 0, n_h * hb - H_O)).contiguous()
    return xp, gp, dict(F=F, stride=S, block_h=hb, H_O=H_O, W_O=W_O)


def _wgrad_impl(x, dy, *, schedule, F, stride=1, padding=0, mask=None, pool=1,
                block_h=None, block_do=None, block_di=None):
    del block_h, block_do, block_di  # consumed by the planner
    if x.ndim == 3:
        x, dy = x[None], dy[None]
        mask = None if mask is None else mask[None]
    if mask is not None:
        dy = epilogue_scatter(dy, mask, pool)
    xp, gp, geo = wgrad_operands(x, dy, F=F, stride=stride, padding=padding,
                                 block_h=schedule.block("block_h"))
    return conv2d_wgrad_kernel(xp, gp, block_do=schedule.block("block_do"),
                               block_di=schedule.block("block_di"), **geo)


wgrad_op = cuda_op("conv2d_wgrad", planner=ConvWgradPlanner,
                   shape_args=_wgrad_shape_args, impl=_wgrad_impl,
                   kernel=conv2d_wgrad_kernel)


def conv2d_wgrad(
    x: torch.Tensor, dy: torch.Tensor, *, F: int, stride: int = 1, padding: int = 0,
    mask: torch.Tensor | None = None, pool: int = 1, schedule: Schedule | None = None,
    block_h: int | None = None, block_do: int | None = None,
    block_di: int | None = None, machine: MachineModel = H100,
) -> torch.Tensor:
    """Filter gradient of :func:`repro_torch.kernels.conv2d.ops.conv2d`.

    ``x``: [B, H, W, D_I] or [H, W, D_I] the forward input; ``dy``: the
    matching conv-output cotangent; ``F`` the filter extent.  One wrapper
    call accumulates dW over the whole (batch, strip) sweep.  With
    ``mask``/``pool``, ``dy`` is the pooled cotangent, scattered to full
    rate first.  Blocking: ``schedule`` > ``block_*`` pins >
    ConvWgradPlanner.
    """
    return wgrad_op(x, dy, schedule=schedule, machine=machine, F=F, stride=stride,
                    padding=padding, mask=mask, pool=pool, block_h=block_h,
                    block_do=block_do, block_di=block_di)
