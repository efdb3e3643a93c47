"""The blocked matmul kernel (``csrc/matmul.cu``): launch wrapper and
plain version.

Replaces ``repro/kernels/matmul/matmul.py::_mm_kernel``: one thread block
per ``block_m x block_n`` output tile, the K grid axis as a loop inside
the block over ``block_k`` steps staged in shared memory, the output tile
written once.  At the planner's tile (:data:`REGISTER_TILE`) the tile lives
in registers: on the tensor cores (``wgmma``, TMA copies) for bf16
operands, on the CUDA cores for f32 and the bf16 x f32 routes; other tiles
run the simple kernel.  Where the (n, m) grid is under one wave of SMs the
K loop is split over a number of blocks fixed by the shapes
(:func:`mm_split`) and the partial slabs are summed in a fixed order.  Operands must already be multiples of the blocks
(``ops.fc_matmul`` pads and slices).

Operands are both f32 or both bf16 (``repro_matmul_f32`` /
``repro_matmul_bf16``), or the CNN's bf16 X against f32 W
(``repro_matmul_bf16xf32_bf16``: fc1; ``repro_matmul_bf16xf32_f32``: the
im2col conv's patch GEMM, whose epilogue runs on the f32 product); the
accumulator is f32 and the output takes X's dtype unless the caller names
f32, as ``_mm_kernel``'s ``preferred_element_type=f32`` and
``astype(o_ref.dtype)`` do.  Shared memory holds each operand in its own
type.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.machine import H100, h100_split
from repro_torch.plan.registry import CudaKernel, activation_dtype

LANE = 8  # the kernel's column group (two float4 runs per thread item)
MAX_GRID_Y = 65535  # M / block_m rides the grid's y axis
REGISTER_TILE = (64, 128, 32)  # (block_m, block_n, block_k) of mm_reg_kernel, mm_wgmma_kernel
TEMPLATES = ("simple", "register", "wgmma")  # the C entry point's `reg` codes


def smem_bytes(block_m: int, block_n: int, block_k: int, in_bytes: int = 4,
               w_bytes: int | None = None) -> int:
    """Shared memory one block allocates: the f32 accumulator tile and two
    stages of the X tile at ``in_bytes`` an element and the W tile at
    ``w_bytes`` (default ``in_bytes``; == MatmulPlanner's H100 budget term
    where the two are equal).  The register kernels hold the tile in
    registers and spend these bytes on a deeper ring of operand stages."""
    w_bytes = in_bytes if w_bytes is None else w_bytes
    return 4 * block_m * block_n + 2 * (in_bytes * block_m * block_k
                                        + w_bytes * block_k * block_n)


def plain_matmul(a, b):
    """a @ b as the kernels compute it: where either is bf16, both
    multiplied in f32 (the f32 product, for the caller to round once);
    other dtypes as they are."""
    if torch.bfloat16 in (a.dtype, b.dtype):
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a, b)


def template(block_m: int, block_n: int, block_k: int,
             dtypes: tuple = (torch.float32,)) -> str:
    """Which kernel a launch with these blocks and operand ``dtypes`` runs:
    at :data:`REGISTER_TILE` "wgmma" (the tensor cores) where every operand
    is bf16, else "register" (f32 and the bf16 x f32 routes); "simple" at
    other tiles.  The launch passes this choice to the C entry point
    (:data:`TEMPLATES`' index), which dispatches on it."""
    if (block_m, block_n, block_k) != REGISTER_TILE:
        return "simple"
    return "wgmma" if set(dtypes) == {torch.bfloat16} else "register"


def mm_split(*, m: int, n: int, k: int, block_m: int, block_n: int, block_k: int,
             in_bytes: int = 4, w_bytes: int | None = None) -> int:
    """Thread blocks that share each output tile's K loop over the (n, m)
    grid (:func:`repro_torch.core.machine.h100_split`)."""
    return h100_split(grid=(m // block_m) * (n // block_n), steps=k // block_k,
                      smem_bytes=smem_bytes(block_m, block_n, block_k, in_bytes, w_bytes))


def mm_partial_bytes(*, m: int, n: int, split: int) -> int:
    """Device memory of the partial f32 slabs (0 without a split)."""
    return 4 * split * m * n if split > 1 else 0


def supported_blocks(block_m: int, block_n: int, block_k: int, in_bytes: int = 4,
                     w_bytes: int | None = None) -> bool:
    """The blocks the kernel takes: multiples of 8 whose tiles (X at
    ``in_bytes`` an element, W at ``w_bytes``) fit one block's shared
    memory."""
    return (all(b > 0 and b % LANE == 0 for b in (block_m, block_n, block_k))
            and smem_bytes(block_m, block_n, block_k, in_bytes, w_bytes)
            <= H100.local_mem_bytes)


def stage_bytes(dtype: torch.dtype) -> int:
    """Bytes a staged operand element takes in shared memory: 2 for bf16,
    else 4 (a plain version at f64 is checked against the f32 kernel's
    blocks)."""
    return 2 if dtype == torch.bfloat16 else 4


def unrounded_dtype(dtype: torch.dtype) -> torch.dtype:
    """What a kernel writes where ``repro`` asks ``out_dtype=f32`` (dX of
    a conv, the im2col GEMM, the recompute conv): f32 from bf16 operands,
    else the operands' own dtype (f32 on the card; a plain version takes
    f64)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _check(x, w, block_m, block_n, block_k, out_dtype=None):
    dtype = activation_dtype("matmul", ("w",), x=x, w=w)
    if out_dtype not in (None, dtype) and (w.dtype, out_dtype) != (torch.float32,) * 2:
        raise ValueError(f"matmul writes x's dtype, or float32 from bfloat16 x and "
                         f"float32 w; got x {x.dtype}, w {w.dtype}, out {out_dtype}")
    if not supported_blocks(block_m, block_n, block_k, stage_bytes(x.dtype),
                            stage_bytes(w.dtype)):
        raise ValueError(f"matmul kernel does not take blocks "
                         f"(m={block_m}, n={block_n}, k={block_k})")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"matmul [{m},{k}]@[{k},{n}] is not a multiple of the "
                         f"blocks ({block_m}, {block_n}, {block_k})")
    return m, n, k


def matmul_plain(x, w, *, block_m: int, block_n: int, block_k: int, out_dtype=None):
    """The kernel's function in plain PyTorch (same contract, same checks):
    the f32 product rounded once to ``out_dtype`` (default x's dtype).  On
    the card it needs TF32 off to be an f32 reference."""
    _check(x, w, block_m, block_n, block_k, out_dtype)
    return plain_matmul(x, w).to(out_dtype or x.dtype)


def matmul_cost(x, w, *, block_m: int, block_n: int, block_k: int,
                out_dtype=None) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: 2·M·N·K; X and W read once at their
    element sizes, Y (in ``out_dtype``, default x's) written once."""
    del block_m, block_n, block_k
    (m, k), n = x.shape, w.shape[1]
    y_bytes = torch.empty((), dtype=out_dtype or x.dtype).element_size()
    return 2.0 * m * n * k, float(x.element_size() * m * k + w.element_size() * k * n
                                  + y_bytes * m * n)


def _launch(kernel: CudaKernel, x, w, *, block_m: int, block_n: int, block_k: int,
            out_dtype=None):
    m, n, k = _check(x, w, block_m, block_n, block_k, out_dtype)
    out_dtype = out_dtype or x.dtype
    route = kernel.operand_dtype(out=out_dtype, x=x, w=w)
    if m // block_m > MAX_GRID_Y:
        raise ValueError(f"matmul M/block_m = {m // block_m} exceeds the grid")
    split = mm_split(m=m, n=n, k=k, block_m=block_m, block_n=block_n, block_k=block_k,
                     in_bytes=x.element_size(), w_bytes=w.element_size())
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    part = (torch.empty((split, m, n), dtype=torch.float32, device=x.device)
            if split > 1 else None)
    kernel.run(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
               ctypes.c_void_p(out.data_ptr()),
               ctypes.c_void_p(part.data_ptr() if part is not None else None),
               m, n, k, block_m, block_n, block_k, split,
               TEMPLATES.index(template(block_m, block_n, block_k, (x.dtype, w.dtype))),
               dtype=route)
    return out


BF, F32 = torch.bfloat16, torch.float32
matmul_kernel = CudaKernel(
    "matmul", source="matmul", symbol="repro_matmul_f32", bf16_symbol="repro_matmul_bf16",
    routes={(BF, F32, BF): "repro_matmul_bf16xf32_bf16",
            (BF, F32, F32): "repro_matmul_bf16xf32_f32"},
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    launch=_launch, plain=matmul_plain, cost=matmul_cost,
)
