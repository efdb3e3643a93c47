"""The FC layer's planned backward: dX = dY @ W^T and dW = X^T @ dY.

Three hand-written kernels in ``csrc/matmul_bwd.cu``, each with its launch
wrapper and plain PyTorch version:

* ``matmul_nt`` — dX[M, K] = dY[M, N] @ W[K, N]^T; no W^T ever exists in
  device memory, and at the planner's tile (:data:`NT_REGISTER_TILE`,
  :func:`nt_template`) the dX tile stays in registers: on the tensor cores
  for bf16 operands (``wgmma`` reads both tiles as they lie, N along their
  rows), on the CUDA cores for f32 and the bf16 x f32 route (both tiles
  staged contraction-major, transposed on the way in).  Where the grid is
  under one wave of SMs the N loop is split over a number of blocks fixed
  by the shapes (:func:`nt_split`) and the partial slabs are summed in a
  fixed order.  Replaces ``repro/kernels/matmul/bwd.py::_mm_nt_kernel``.
* ``matmul_tn`` — dW[K, N] = X[M, K]^T @ dY[M, N]; M streams as the
  contraction, both tiles staged as they lie.  At the planner's tile
  (:data:`TN_REGISTER_TILE`, :func:`tn_template`) the dW tile stays in
  registers: on the tensor cores for bf16 operands (``wgmma`` reads X
  as Xᵀ, M along its rows, through the transpose bit), on the CUDA cores
  for f32; small grids split the M loop (:func:`tn_split`) as NT's
  does.  Replaces ``::_mm_tn_kernel``.
* ``matmul_dx_dw`` — both from one read of each dY tile.  At the
  planner's tile (:data:`DXDW_REGISTER_TILE`) and one to three m-blocks
  (:func:`dxdw_template`) the whole-M dX strip and the dW tile stay in
  registers and the X strip in shared memory; the n-blocks are split over
  a number of blocks fixed by the shapes (:func:`dxdw_split`), each dW
  tile written by one block and the partial dX strips summed in a fixed
  order.  Replaces ``::_mm_dxdw_kernel``.

Operands are both f32 or both bf16 (a ``_f32`` and a ``_bf16`` C entry
point per kernel), or, for NT and the fused kernel, the CNN's bf16 dY and X
against f32 W (``_bf16xf32``: fc1 at compute_dtype bf16, where ``repro``'s
type promotion keeps the weights f32; TN's operands are X and dY, both
bf16 there).  The accumulators are f32 and dX and dW come out f32, as
``repro``'s FC backward asks of its kernels (``out_dtype=f32``, then a cast
to x's and w's dtypes in ``core/fc_layer.py``).

Two ops sit on the plan layer: ``matmul_dx`` (:class:`MatmulDxPlanner`)
and ``matmul_dw`` (:class:`MatmulDwPlanner`).  :func:`matmul_dx_dw` is not
an op of its own: the FC layer dispatches to it off the dX schedule's
``fused_dxdw`` tag.  Block names use the forward roles: ``block_m`` the
batch tile, ``block_k`` the input-feature tile, ``block_n`` the output
tile.  Operands are zero-padded to the blocks and the results sliced back,
as ``repro/kernels/matmul/bwd.py`` does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.machine import H100, MachineModel, h100_split
from repro_torch.kernels.matmul.matmul import plain_matmul, stage_bytes
from repro_torch.plan import (
    CudaKernel, MatmulDwPlanner, MatmulDxPlanner, Schedule, cuda_op, pad_dim, round_up,
)
from repro_torch.plan.registry import activation_dtype

LANE = 8  # the kernels' column group (two float4 runs per thread item)
MAX_GRID_Y = 65535
NT_REGISTER_TILE = (64, 32, 128)  # (block_m, block_n, block_k) of NT's register and wgmma kernels
TN_REGISTER_TILE = (32, 128, 64)  # (block_m, block_n, block_k) of TN's register and wgmma kernels
TN_TEMPLATES = ("simple", "register", "wgmma")  # TN's C entry point's `tmpl` codes
DXDW_REGISTER_TILE = (64, 32, 128)  # (block_m, block_n, block_k) of mm_dxdw_reg_kernel
DXDW_REGISTER_M_BLOCKS = 3  # the most m-blocks of dX its threads hold
DXDW_MIXED_M_BLOCKS = 2  # the m-blocks its bf16 x f32 route is built for (the CNN at 128)
OUT_DTYPE = torch.float32  # dX and dW, whatever the operands' dtype


# -- oracles ---------------------------------------------------------------------


def matmul_dx_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX = dY @ W^T in f32 (leading dims of ``g`` kept)."""
    return torch.matmul(g.float(), w.float().t())


def matmul_dw_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW = X^T @ dY in f32 (leading dims of both flatten into M)."""
    x2, g2 = x.reshape(-1, x.shape[-1]).float(), g.reshape(-1, g.shape[-1]).float()
    return torch.matmul(x2.t(), g2)


# -- shared memory and the blocks the kernels take ---------------------------------


def smem_bytes_nt(block_m: int, block_n: int, block_k: int, in_bytes: int = 4,
                  w_bytes: int | None = None) -> int:
    """The f32 dX tile [bm][bk] + two stages of the dY tile [bm][bn] at
    ``in_bytes`` an element and the transposed W tile [bn][bk] at
    ``w_bytes`` (default ``in_bytes``; == MatmulDxPlanner's H100 budget
    term where the two are equal)."""
    w_bytes = in_bytes if w_bytes is None else w_bytes
    return 4 * block_m * block_k + 2 * (in_bytes * block_m * block_n
                                        + w_bytes * block_n * block_k)


def smem_bytes_tn(block_m: int, block_n: int, block_k: int, in_bytes: int = 4) -> int:
    """The f32 dW tile [bk][bn] + two stages of the X tile [bm][bk] and the
    dY tile [bm][bn] at ``in_bytes`` an element (== MatmulDwPlanner's H100
    budget term)."""
    return 4 * block_k * block_n + 2 * in_bytes * (block_m * block_k + block_m * block_n)


def smem_bytes_dxdw(m: int, block_m: int, block_n: int, block_k: int,
                    in_bytes: int = 4, w_bytes: int | None = None) -> int:
    """Two stages of the dY and X tiles at ``in_bytes`` an element and of
    the W tile at ``w_bytes`` (default ``in_bytes``) + the whole-M f32 dX
    strip [m][bk] + the f32 dW tile [bk][bn] (== the fused_dxdw schedule's
    H100 budget where the two sizes are equal).  Both kernels take exactly
    this; the register kernel keeps the X strip in the strip's room and
    the dY tile (both ways) and the W tile in the rest."""
    w_bytes = in_bytes if w_bytes is None else w_bytes
    return (2 * (in_bytes * (block_m * block_n + block_m * block_k)
                 + w_bytes * block_k * block_n)
            + 4 * (m * block_k + block_k * block_n))


def _lane_blocks(*blocks: int) -> bool:
    return all(b > 0 and b % LANE == 0 for b in blocks)


def supported_blocks(kernel: str, *, block_m: int, block_n: int, block_k: int,
                     m: int = 0, in_bytes: int = 4, w_bytes: int | None = None) -> bool:
    """The blocks ``kernel`` ("matmul_nt" / "matmul_tn" / "matmul_dx_dw")
    takes: multiples of 8 whose tiles (activations at ``in_bytes`` an
    element, W at ``w_bytes``; for the fused kernel with the [m, block_k]
    dX strip of an m-row batch) fit one block's shared memory."""
    smem = {"matmul_nt": lambda: smem_bytes_nt(block_m, block_n, block_k, in_bytes,
                                               w_bytes),
            "matmul_tn": lambda: smem_bytes_tn(block_m, block_n, block_k, in_bytes),
            "matmul_dx_dw": lambda: smem_bytes_dxdw(m, block_m, block_n, block_k,
                                                    in_bytes, w_bytes)}
    return (_lane_blocks(block_m, block_n, block_k)
            and smem[kernel]() <= H100.local_mem_bytes)


def nt_split(*, m: int, n: int, k: int, block_m: int, block_n: int, block_k: int,
             in_bytes: int = 4, w_bytes: int | None = None) -> int:
    """Thread blocks that share each dX tile's N loop over the (k, m) grid
    (:func:`repro_torch.core.machine.h100_split`)."""
    return h100_split(grid=(m // block_m) * (k // block_k), steps=n // block_n,
                      smem_bytes=smem_bytes_nt(block_m, block_n, block_k, in_bytes,
                                               w_bytes))


def nt_partial_bytes(*, m: int, k: int, split: int) -> int:
    """Device memory of NT's (or the fused kernel's) partial f32 dX slabs
    (0 without a split)."""
    return 4 * split * m * k if split > 1 else 0


def nt_template(block_m: int, block_n: int, block_k: int,
                dtypes: tuple = (torch.float32,)) -> str:
    """Which kernel an NT launch with these blocks and operand ``dtypes``
    runs: at :data:`NT_REGISTER_TILE` "wgmma" (the tensor cores) where
    every operand is bf16, else "register" (f32 and the bf16 x f32 route);
    "simple" at other tiles.  The C entry point makes the same choice from
    the tile and its operands' type."""
    if (block_m, block_n, block_k) != NT_REGISTER_TILE:
        return "simple"
    return "wgmma" if set(dtypes) == {torch.bfloat16} else "register"


def tn_template(block_m: int, block_n: int, block_k: int,
                dtypes: tuple = (torch.float32,)) -> str:
    """Which kernel a TN launch with these blocks and operand ``dtypes``
    runs: at :data:`TN_REGISTER_TILE` "wgmma" (the tensor cores) where every
    operand is bf16, else "register"; "simple" at other tiles.  The launch
    passes this choice to the C entry point (:data:`TN_TEMPLATES`' index),
    which dispatches on it."""
    if (block_m, block_n, block_k) != TN_REGISTER_TILE:
        return "simple"
    return "wgmma" if set(dtypes) == {torch.bfloat16} else "register"


def tn_split(*, m: int, n: int, k: int, block_m: int, block_n: int, block_k: int,
             in_bytes: int = 4) -> int:
    """Thread blocks that share each dW tile's M loop over the (n, k) grid
    (:func:`repro_torch.core.machine.h100_split`)."""
    return h100_split(grid=(n // block_n) * (k // block_k), steps=m // block_m,
                      smem_bytes=smem_bytes_tn(block_m, block_n, block_k, in_bytes))


def tn_partial_bytes(*, k: int, n: int, split: int) -> int:
    """Device memory of TN's partial f32 dW slabs (0 without a split)."""
    return 4 * split * k * n if split > 1 else 0


def dxdw_template(block_m: int, block_n: int, block_k: int, m: int,
                  mixed: bool = False) -> str:
    """Which kernel a fused launch with these blocks and ``m`` rows runs:
    "register" at :data:`DXDW_REGISTER_TILE` with one to
    :data:`DXDW_REGISTER_M_BLOCKS` whole m-blocks — on the ``mixed`` route
    (bf16 dY and X against f32 W) with :data:`DXDW_MIXED_M_BLOCKS` alone,
    the only count built for it — else "simple".  The launch passes this
    choice to the C entry point, which dispatches on it."""
    n_m = m // block_m if m % block_m == 0 else 0
    fits = n_m == DXDW_MIXED_M_BLOCKS if mixed else 1 <= n_m <= DXDW_REGISTER_M_BLOCKS
    return ("register" if (block_m, block_n, block_k) == DXDW_REGISTER_TILE and fits
            else "simple")


def dxdw_split(*, m: int, n: int, k: int, block_m: int, block_n: int, block_k: int,
               in_bytes: int = 4, w_bytes: int | None = None) -> int:
    """Thread blocks that share each k-block's n-blocks in the fused kernel
    (:func:`repro_torch.core.machine.h100_split` over the K/block_k grid)."""
    return h100_split(grid=k // block_k, steps=n // block_n,
                      smem_bytes=smem_bytes_dxdw(m, block_m, block_n, block_k, in_bytes,
                                                 w_bytes))


def _check_multiple(name, dims, blocks):
    if any(d % b for d, b in zip(dims, blocks)):
        raise ValueError(f"{name}: dims {dims} are not multiples of the blocks {blocks}")


def _check_nt(g, w, *, block_m, block_n, block_k):
    in_bytes = stage_bytes(activation_dtype("matmul_nt", ("w",), g=g, w=w))
    if not supported_blocks("matmul_nt", block_m=block_m, block_n=block_n,
                            block_k=block_k, in_bytes=in_bytes,
                            w_bytes=stage_bytes(w.dtype)):
        raise ValueError(f"matmul_nt kernel does not take blocks "
                         f"(m={block_m}, n={block_n}, k={block_k})")
    if g.ndim != 2 or w.ndim != 2 or g.shape[1] != w.shape[1]:
        raise ValueError(f"matmul_nt shapes {tuple(g.shape)} @ {tuple(w.shape)}^T")
    (m, n), k = g.shape, w.shape[0]
    _check_multiple("matmul_nt", (m, n, k), (block_m, block_n, block_k))
    return m, n, k


def _check_tn(x, g, *, block_m, block_n, block_k):
    in_bytes = stage_bytes(activation_dtype("matmul_tn", x=x, g=g))
    if not supported_blocks("matmul_tn", block_m=block_m, block_n=block_n,
                            block_k=block_k, in_bytes=in_bytes):
        raise ValueError(f"matmul_tn kernel does not take blocks "
                         f"(m={block_m}, n={block_n}, k={block_k})")
    if x.ndim != 2 or g.ndim != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(f"matmul_tn shapes {tuple(x.shape)}^T @ {tuple(g.shape)}")
    (m, k), n = x.shape, g.shape[1]
    _check_multiple("matmul_tn", (m, n, k), (block_m, block_n, block_k))
    return m, n, k


def _check_dxdw(g, w, x, *, block_m, block_n, block_k):
    if g.ndim != 2 or w.ndim != 2 or x.ndim != 2 or g.shape[1] != w.shape[1] \
            or x.shape != (g.shape[0], w.shape[0]):
        raise ValueError(f"matmul_dx_dw shapes g={tuple(g.shape)} w={tuple(w.shape)} "
                         f"x={tuple(x.shape)}")
    (m, n), k = g.shape, w.shape[0]
    in_bytes = stage_bytes(activation_dtype("matmul_dx_dw", ("w",), g=g, w=w, x=x))
    if not supported_blocks("matmul_dx_dw", block_m=block_m, block_n=block_n,
                            block_k=block_k, m=m, in_bytes=in_bytes,
                            w_bytes=stage_bytes(w.dtype)):
        raise ValueError(f"matmul_dx_dw kernel does not take blocks (m={block_m}, "
                         f"n={block_n}, k={block_k}) with a {m}-row dX strip")
    _check_multiple("matmul_dx_dw", (m, n, k), (block_m, block_n, block_k))
    return m, n, k


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# -- plain versions (CPU tensors; on the card only to compare) -----------------------


def matmul_nt_plain(g, w, *, block_m: int, block_n: int, block_k: int):
    """The NT kernel's function in plain PyTorch (same contract and checks):
    the f32 product of bf16 operands; on the card it needs TF32 off to be
    an f32 reference."""
    _check_nt(g, w, block_m=block_m, block_n=block_n, block_k=block_k)
    return plain_matmul(g, w.t())


def matmul_tn_plain(x, g, *, block_m: int, block_n: int, block_k: int):
    """The TN kernel's function in plain PyTorch (same contract and checks)."""
    _check_tn(x, g, block_m=block_m, block_n=block_n, block_k=block_k)
    return plain_matmul(x.t(), g)


def matmul_dxdw_plain(g, w, x, *, block_m: int, block_n: int, block_k: int):
    """The fused kernel's function in plain PyTorch: (dY @ W^T, X^T @ dY)."""
    _check_dxdw(g, w, x, block_m=block_m, block_n=block_n, block_k=block_k)
    return plain_matmul(g, w.t()), plain_matmul(x.t(), g)


# -- costs: each input read once, each output written once ------------------------


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


_OUT_BYTES = torch.empty((), dtype=OUT_DTYPE).element_size()


def matmul_nt_cost(g, w, *, block_m: int, block_n: int, block_k: int):
    """(FLOPs, bytes) of dX = dY·Wᵀ: 2·M·N·K; dY and W read at their
    element size, the f32 dX written."""
    del block_m, block_n, block_k
    (m, n), k = g.shape, w.shape[0]
    return 2.0 * m * n * k, float(_bytes(g, w) + _OUT_BYTES * m * k)


def matmul_tn_cost(x, g, *, block_m: int, block_n: int, block_k: int):
    """(FLOPs, bytes) of dW = Xᵀ·dY: 2·M·N·K; X and dY read at their
    element size, the f32 dW written."""
    del block_m, block_n, block_k
    (m, k), n = x.shape, g.shape[1]
    return 2.0 * m * n * k, float(_bytes(x, g) + _OUT_BYTES * k * n)


def matmul_dxdw_cost(g, w, x, *, block_m: int, block_n: int, block_k: int):
    """(FLOPs, bytes) of dX and dW in one pass: 4·M·N·K; dY, W and X read
    once at their element size, the f32 dX and dW written once."""
    del block_m, block_n, block_k
    (m, n), k = g.shape, w.shape[0]
    return 4.0 * m * n * k, float(_bytes(g, w, x) + _OUT_BYTES * (m * k + k * n))


# -- launch wrappers -------------------------------------------------------------


def _launch_nt(kernel: CudaKernel, g, w, *, block_m: int, block_n: int, block_k: int):
    m, n, k = _check_nt(g, w, block_m=block_m, block_n=block_n, block_k=block_k)
    dtype = kernel.operand_dtype(g=g, w=w)
    if m // block_m > MAX_GRID_Y:
        raise ValueError(f"matmul_nt M/block_m = {m // block_m} exceeds the grid")
    split = nt_split(m=m, n=n, k=k, block_m=block_m, block_n=block_n, block_k=block_k,
                     in_bytes=g.element_size(), w_bytes=w.element_size())
    out = torch.empty((m, k), dtype=OUT_DTYPE, device=g.device)
    part = (torch.empty((split, m, k), dtype=torch.float32, device=g.device)
            if split > 1 else None)
    kernel.run(_ptr(g), _ptr(w), _ptr(out),
               ctypes.c_void_p(part.data_ptr() if part is not None else None),
               m, n, k, block_m, block_n, block_k, split, dtype=dtype)
    return out


def _launch_tn(kernel: CudaKernel, x, g, *, block_m: int, block_n: int, block_k: int):
    m, n, k = _check_tn(x, g, block_m=block_m, block_n=block_n, block_k=block_k)
    dtype = kernel.operand_dtype(x=x, g=g)
    if k // block_k > MAX_GRID_Y:
        raise ValueError(f"matmul_tn K/block_k = {k // block_k} exceeds the grid")
    split = tn_split(m=m, n=n, k=k, block_m=block_m, block_n=block_n, block_k=block_k,
                     in_bytes=x.element_size())
    out = torch.empty((k, n), dtype=OUT_DTYPE, device=x.device)
    part = (torch.empty((split, k, n), dtype=torch.float32, device=x.device)
            if split > 1 else None)
    kernel.run(_ptr(x), _ptr(g), _ptr(out),
               ctypes.c_void_p(part.data_ptr() if part is not None else None),
               m, n, k, block_m, block_n, block_k, split,
               TN_TEMPLATES.index(tn_template(block_m, block_n, block_k, (x.dtype, g.dtype))),
               dtype=dtype)
    return out


def _launch_dxdw(kernel: CudaKernel, g, w, x, *, block_m: int, block_n: int,
                 block_k: int):
    m, n, k = _check_dxdw(g, w, x, block_m=block_m, block_n=block_n, block_k=block_k)
    dtype = kernel.operand_dtype(g=g, w=w, x=x)
    split = dxdw_split(m=m, n=n, k=k, block_m=block_m, block_n=block_n, block_k=block_k,
                       in_bytes=g.element_size(), w_bytes=w.element_size())
    dx = torch.empty((m, k), dtype=OUT_DTYPE, device=g.device)
    dw = torch.empty((k, n), dtype=OUT_DTYPE, device=g.device)
    part = (torch.empty((split, m, k), dtype=torch.float32, device=g.device)
            if split > 1 else None)
    kernel.run(_ptr(g), _ptr(w), _ptr(x), _ptr(dx), _ptr(dw),
               ctypes.c_void_p(part.data_ptr() if part is not None else None),
               m, n, k, block_m, block_n, block_k, split,
               int(dxdw_template(block_m, block_n, block_k, m, mixed=w.dtype != g.dtype)
                   == "register"), dtype=dtype)
    return dx, dw


BF, F32 = torch.bfloat16, torch.float32
matmul_nt_kernel = CudaKernel(
    "matmul_nt", source="matmul_bwd", symbol="repro_matmul_nt_f32",
    bf16_symbol="repro_matmul_nt_bf16", routes={(BF, F32): "repro_matmul_nt_bf16xf32"},
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    launch=_launch_nt, plain=matmul_nt_plain, cost=matmul_nt_cost,
)
matmul_tn_kernel = CudaKernel(
    "matmul_tn", source="matmul_bwd", symbol="repro_matmul_tn_f32",
    bf16_symbol="repro_matmul_tn_bf16",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    launch=_launch_tn, plain=matmul_tn_plain, cost=matmul_tn_cost,
)
matmul_dxdw_kernel = CudaKernel(
    "matmul_dx_dw", source="matmul_bwd", symbol="repro_matmul_dxdw_f32",
    bf16_symbol="repro_matmul_dxdw_bf16",
    routes={(BF, F32, BF): "repro_matmul_dxdw_bf16xf32"},
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    launch=_launch_dxdw, plain=matmul_dxdw_plain, cost=matmul_dxdw_cost,
)


# -- ops ------------------------------------------------------------------------


def _flat_m(t: torch.Tensor) -> int:
    m = 1
    for d in t.shape[:-1]:
        m *= d
    return m


def _dx_shape_args(g, w, *, block_m=None, block_n=None, block_k=None, algorithm=None):
    k, n = w.shape
    return dict(m=_flat_m(g), n=n, k=k, in_bytes=g.element_size(),
                block_m=block_m, block_n=block_n, block_k=block_k,
                algorithm=algorithm)


def _blocks(schedule: Schedule) -> tuple[int, int, int]:
    return (schedule.block("block_m"), schedule.block("block_n"),
            schedule.block("block_k"))


def _dx_impl(g, w, *, schedule, block_m=None, block_n=None, block_k=None,
             algorithm=None):
    del block_m, block_n, block_k, algorithm  # consumed by the planner
    if schedule.algorithm == "fused_dxdw":
        # A fused schedule reaching the dx-only op (the autotuner timing a
        # fused candidate on the matmul_dx cell's (dY, W) signature): run
        # the fused kernel on a zero X so the measurement pays the kernel's
        # whole cost; the dW half is discarded.  The FC layer dispatches to
        # matmul_dx_dw itself and never lands here.
        x0 = g.new_zeros((*g.shape[:-1], w.shape[0]))
        return matmul_dx_dw(g, w, x0, schedule=schedule)[0]
    lead = g.shape[:-1]
    k, n = w.shape
    g2 = g.reshape(-1, n)
    m = g2.shape[0]
    bm, bn, bk = _blocks(schedule)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    g2 = pad_dim(pad_dim(g2, 0, mp), 1, np_).contiguous()
    wp = pad_dim(pad_dim(w, 0, kp), 1, np_).contiguous()
    out = matmul_nt_kernel(g2, wp, block_m=bm, block_n=bn, block_k=bk)
    return out[:m, :k].reshape(*lead, k)


dx_op = cuda_op("matmul_dx", planner=MatmulDxPlanner, shape_args=_dx_shape_args,
                impl=_dx_impl, kernel=matmul_nt_kernel)


def _dw_shape_args(x, g, *, block_m=None, block_n=None, block_k=None):
    return dict(m=_flat_m(x), n=g.shape[-1], k=x.shape[-1], in_bytes=x.element_size(),
                block_m=block_m, block_n=block_n, block_k=block_k)


def _dw_impl(x, g, *, schedule, block_m=None, block_n=None, block_k=None):
    del block_m, block_n, block_k  # consumed by the planner
    k, n = x.shape[-1], g.shape[-1]
    x2, g2 = x.reshape(-1, k), g.reshape(-1, n)
    m = x2.shape[0]
    bm, bn, bk = _blocks(schedule)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    x2 = pad_dim(pad_dim(x2, 0, mp), 1, kp).contiguous()
    g2 = pad_dim(pad_dim(g2, 0, mp), 1, np_).contiguous()
    out = matmul_tn_kernel(x2, g2, block_m=bm, block_n=bn, block_k=bk)
    return out[:k, :n]


dw_op = cuda_op("matmul_dw", planner=MatmulDwPlanner, shape_args=_dw_shape_args,
                impl=_dw_impl, kernel=matmul_tn_kernel)


def matmul_dx(g: torch.Tensor, w: torch.Tensor, *, schedule: Schedule | None = None,
              block_m: int | None = None, block_n: int | None = None,
              block_k: int | None = None, machine: MachineModel = H100) -> torch.Tensor:
    """Input gradient of :func:`repro_torch.kernels.matmul.ops.fc_matmul`.

    ``g``: [..., N] cotangent of the FC output; ``w``: [K, N] the forward
    weights.  Leading dims of ``g`` flatten into M.  Blocking:
    ``schedule`` > ``block_*`` pins > MatmulDxPlanner.
    """
    return dx_op(g, w, schedule=schedule, machine=machine,
                 block_m=block_m, block_n=block_n, block_k=block_k)


def matmul_dw(x: torch.Tensor, g: torch.Tensor, *, schedule: Schedule | None = None,
              block_m: int | None = None, block_n: int | None = None,
              block_k: int | None = None, machine: MachineModel = H100) -> torch.Tensor:
    """Weight gradient of :func:`repro_torch.kernels.matmul.ops.fc_matmul`.

    ``x``: [..., K] the forward activations; ``g``: [..., N] the matching
    output cotangent (same leading dims, flattened into M).  Blocking:
    ``schedule`` > ``block_*`` pins > MatmulDwPlanner.
    """
    return dw_op(x, g, schedule=schedule, machine=machine,
                 block_m=block_m, block_n=block_n, block_k=block_k)


def matmul_dx_dw(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor, *,
                 schedule: Schedule | None = None,
                 machine: MachineModel = H100) -> tuple[torch.Tensor, torch.Tensor]:
    """Both FC gradients from the fused kernel, one read of each dY tile.

    ``g``: [..., N]; ``w``: [K, N]; ``x``: [..., K] (leading dims flatten
    into M).  ``schedule`` is a ``matmul_dx`` Schedule — normally the
    ``fused_dxdw`` variant, whose budget covers the whole-M dX strip; when
    omitted the planner builds one.
    """
    if schedule is None:
        schedule = dx_op.plan(g, w, machine=machine, algorithm="fused_dxdw")
    lead = g.shape[:-1]
    k, n = w.shape
    g2, x2 = g.reshape(-1, n), x.reshape(-1, k)
    m = g2.shape[0]
    bm, bn, bk = _blocks(schedule)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    g2 = pad_dim(pad_dim(g2, 0, mp), 1, np_).contiguous()
    wp = pad_dim(pad_dim(w, 0, kp), 1, np_).contiguous()
    x2 = pad_dim(pad_dim(x2, 0, mp), 1, kp).contiguous()
    dx, dw = matmul_dxdw_kernel(g2, wp, x2, block_m=bm, block_n=bn, block_k=bk)
    return dx[:m, :k].reshape(*lead, k), dw[:k, :n]
