"""The fused direct conv kernel (``csrc/conv2d.cu``): launch wrapper and
plain version.

Replaces ``repro/kernels/conv2d/conv2d.py::_conv_kernel``: batched,
strip-tiled stacked direct conv (Algs 1/2) with bias, ReLU, the
``pool x pool`` max-pool and the optional int8 mask fused into the flush.
One thread block per (image, strip, output stack); the d_in grid axis is a
loop inside the block.  At F = 3, stride 1 (every main-path conv and
dgrad) the output tile lives in registers (:func:`register_layout`); other
geometries run the simple kernel.

Operands are f32 (``repro_conv2d_fused_f32``), or the CNN's bf16 input
against f32 filters and bias (``repro_conv2d_fused_bf16xf32_bf16``: the
forward, which writes x's dtype; ``..._f32``: dgrad and the recompute
conv, which write f32), as ``_conv_kernel``'s ``preferred_element_type=f32``
with its bias, ReLU, pool and mask on the f32 sums and ``astype(o_ref.dtype)``
at the end.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.machine import H100
from repro_torch.plan.registry import CudaKernel

LANE = 8  # output channels of one thread item
MAX_GRID_YZ = 65535  # strips and images ride the grid's y and z axes
THREADS = 256  # one thread block
REGISTER_RUNS = (4, 8, 16)  # pixels along a row of one register-kernel item


def smem_bytes(*, block_h: int, block_do: int, block_di: int, W_O: int,
               F: int, S: int, x_bytes: int = 4) -> int:
    """Shared memory one block allocates: the f32 accumulator strip and two
    stages of the halo'd input strip at ``x_bytes`` an element and the f32
    filter block (== ConvPlanner's H100 budget term at f32; at bf16 the
    planner charges the filters at two bytes too)."""
    h_halo, w_str = (block_h - 1) * S + F, (W_O - 1) * S + F
    return (4 * (block_h * W_O * block_do + 2 * F * F * block_di * block_do)
            + 2 * x_bytes * h_halo * w_str * block_di)


def register_layout(*, block_h: int, block_do: int, block_di: int, W_O: int,
                    F: int, S: int) -> dict | None:
    """How the register kernel lays a block's tile over its 256 threads, or
    None where the simple kernel runs it.  The register kernel takes F = 3,
    stride 1, a multiple-of-8 output stack and ``block_di`` = 4 * 2^j; a
    thread item is ``run`` output pixels along a row x 8 channels, ``run``
    the shortest of :data:`REGISTER_RUNS` that divides W_O and brings the
    items to at most 256; ``groups`` = 256 // items channel groups share
    each d_in step's channels."""
    q = block_di // 4
    if (F != 3 or S != 1 or block_do % LANE or block_di % 4 or q < 1
            or q & (q - 1)):
        return None
    for run in REGISTER_RUNS:
        items = (block_h * W_O // run) * (block_do // LANE)
        if W_O % run == 0 and items <= THREADS:
            return dict(run=run, items=items, groups=THREADS // items)
    return None


def supported_blocks(*, block_h: int, block_do: int, block_di: int, W_O: int,
                     F: int, S: int, pool: int = 1, x_bytes: int = 4) -> bool:
    """The blocks the kernel takes: a multiple-of-8 output stack, a strip
    that tiles the pool window, and tiles (the input at ``x_bytes`` an
    element) that fit one block's shared memory."""
    return (block_do > 0 and block_do % LANE == 0 and block_di > 0
            and block_h > 0 and pool >= 1 and block_h % pool == 0
            and W_O % pool == 0
            and smem_bytes(block_h=block_h, block_do=block_do, block_di=block_di,
                           W_O=W_O, F=F, S=S, x_bytes=x_bytes)
            <= H100.local_mem_bytes)


def _out_dtype(x_pad, f, out_dtype=None) -> torch.dtype:
    """The output dtype of a call: x's unless ``out_dtype`` names another;
    raise unless the operands are one dtype other than bf16 (f32 on the
    card, f64 in a plain version) writing it, or bf16 x against f32
    filters writing bf16 or f32."""
    out = out_dtype or x_pad.dtype
    mixed = (x_pad.dtype, f.dtype) == (torch.bfloat16, torch.float32)
    if not (x_pad.dtype == f.dtype == out != torch.bfloat16
            or (mixed and out in (torch.bfloat16, torch.float32))):
        raise ValueError(f"conv2d takes x and f of one dtype writing it, or bfloat16 x "
                         f"against float32 f writing bfloat16 or float32; got x "
                         f"{x_pad.dtype}, f {f.dtype}, out {out}")
    return out


def _check(x_pad, f, bias, *, stride, block_h, block_do, block_di, H_O, W_O,
           relu, pool, emit_mask, out_dtype=None):
    if x_pad.ndim != 4 or f.ndim != 4 or f.shape[0] != f.shape[1]:
        raise ValueError(f"conv2d shapes x={tuple(x_pad.shape)} f={tuple(f.shape)}")
    out = _out_dtype(x_pad, f, out_dtype)
    B, H_in, W_in, d_in = x_pad.shape
    Fk, _, d_in2, d_out = f.shape
    if d_in2 != d_in or tuple(bias.shape) != (d_out,):
        raise ValueError(f"conv2d channels: x {d_in}, f {tuple(f.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if not supported_blocks(block_h=block_h, block_do=block_do, block_di=block_di,
                            W_O=W_O, F=Fk, S=stride, pool=pool,
                            x_bytes=4 if x_pad.dtype == torch.float64
                            else x_pad.element_size()):
        raise ValueError(f"conv2d kernel does not take blocks (h={block_h}, "
                         f"do={block_do}, di={block_di}) at W_O={W_O}, F={Fk}, "
                         f"S={stride}, pool={pool}")
    n_h = -(-H_O // block_h)
    if H_in < (n_h * block_h - 1) * stride + Fk or W_in < (W_O - 1) * stride + Fk:
        raise ValueError(f"conv2d input {H_in}x{W_in} does not cover {n_h} strips "
                         f"of {block_h} rows x {W_O} cols")
    if emit_mask and not relu:
        raise ValueError("the epilogue mask encodes ReLU liveness: needs relu")
    return B, d_out, Fk, n_h, out


def conv2d_fused_plain(x_pad, f, bias, *, stride: int, block_h: int,
                       block_do: int, block_di: int, H_O: int, W_O: int,
                       relu: bool = False, pool: int = 1, emit_mask: bool = False,
                       out_dtype=None):
    """The kernel's function in plain PyTorch (same contract, same checks):
    [B, n_h*block_h // pool, W_O // pool, D_O] (rows past H_O computed from
    the caller's padding rows), and with ``emit_mask`` also the int8 mask.
    At bf16 x the conv, bias, ReLU, pool and mask run on the f32 product of
    the operands and the output is rounded once to ``out_dtype`` (default
    x's dtype).  On the card it needs cuDNN's TF32 off to be an f32
    reference."""
    B, d_out, _, n_h, out_dtype = _check(
        x_pad, f, bias, stride=stride, block_h=block_h, block_do=block_do,
        block_di=block_di, H_O=H_O, W_O=W_O, relu=relu, pool=pool,
        emit_mask=emit_mask, out_dtype=out_dtype)
    rows = n_h * block_h
    if x_pad.dtype == torch.bfloat16:
        x_pad, f, bias = x_pad.float(), f.float(), bias.float()
    y = F.conv2d(x_pad.permute(0, 3, 1, 2), f.permute(3, 2, 0, 1), stride=stride)
    y = y[:, :, :rows, :W_O].permute(0, 2, 3, 1) + bias
    if relu:
        y = torch.relu(y)
    win = (y.reshape(B, rows // pool, pool, W_O // pool, pool, d_out)
           .permute(0, 1, 3, 5, 2, 4).reshape(B, rows // pool, W_O // pool, d_out,
                                              pool * pool))
    out, arg = win.max(dim=-1)  # first window position on ties
    if not emit_mask:
        return out.to(out_dtype).contiguous()
    dead = pool * pool if pool > 1 else 1
    live = arg if pool > 1 else torch.zeros_like(arg)
    mask = torch.where(out > 0, live, torch.full_like(arg, dead)).to(torch.int8)
    return out.to(out_dtype).contiguous(), mask


def conv2d_cost(x_pad, f, bias, *, stride: int, block_h: int, block_do: int,
                block_di: int, H_O: int, W_O: int, relu: bool = False, pool: int = 1,
                emit_mask: bool = False, out_dtype=None) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: 2 FLOP a tap and channel pair at every
    output pixel; the operands read once at their element sizes, the
    (pooled) output (in ``out_dtype``, default x's) and the int8 mask
    written once."""
    del stride, block_h, block_do, block_di, relu
    B, d_in = x_pad.shape[0], x_pad.shape[-1]
    Fk, d_out = f.shape[0], f.shape[-1]
    out = B * (H_O // pool) * (W_O // pool) * d_out
    y_bytes = torch.empty((), dtype=out_dtype or x_pad.dtype).element_size()
    nbytes = (x_pad.numel() * x_pad.element_size() + f.numel() * f.element_size()
              + bias.numel() * bias.element_size() + y_bytes * out
              + (out if emit_mask else 0))
    return 2.0 * B * H_O * W_O * Fk * Fk * d_in * d_out, float(nbytes)


def _launch(kernel: CudaKernel, x_pad, f, bias, *, stride: int, block_h: int,
            block_do: int, block_di: int, H_O: int, W_O: int, relu: bool = False,
            pool: int = 1, emit_mask: bool = False, out_dtype=None):
    B, d_out, Fk, n_h, out_dtype = _check(
        x_pad, f, bias, stride=stride, block_h=block_h, block_do=block_do,
        block_di=block_di, H_O=H_O, W_O=W_O, relu=relu, pool=pool,
        emit_mask=emit_mask, out_dtype=out_dtype)
    route = kernel.operand_dtype(out=out_dtype, x=x_pad, f=f, bias=bias)
    if n_h > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"conv2d grid ({n_h} strips, {B} images) too large")
    _, H_in, W_in, d_in = x_pad.shape
    shape = (B, n_h * block_h // pool, W_O // pool, d_out)
    out = torch.empty(shape, dtype=out_dtype, device=x_pad.device)
    mask = torch.empty(shape, dtype=torch.int8, device=x_pad.device) if emit_mask else None
    layout = register_layout(block_h=block_h, block_do=block_do, block_di=block_di,
                             W_O=W_O, F=Fk, S=stride)
    kernel.run(ctypes.c_void_p(x_pad.data_ptr()), ctypes.c_void_p(f.data_ptr()),
               ctypes.c_void_p(bias.data_ptr()), ctypes.c_void_p(out.data_ptr()),
               ctypes.c_void_p(mask.data_ptr() if emit_mask else None),
               B, H_in, W_in, d_in, d_out, Fk, stride, W_O, n_h, block_h,
               block_di, block_do, int(relu), pool, layout["run"] if layout else 0,
               dtype=route)
    return (out, mask) if emit_mask else out


BF, F32 = torch.bfloat16, torch.float32
conv2d_kernel = CudaKernel(
    "conv2d", source="conv2d", symbol="repro_conv2d_fused_f32",
    routes={(BF, F32, F32, BF): "repro_conv2d_fused_bf16xf32_bf16",
            (BF, F32, F32, F32): "repro_conv2d_fused_bf16xf32_f32"},
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
    launch=_launch, plain=conv2d_fused_plain, cost=conv2d_cost,
)
