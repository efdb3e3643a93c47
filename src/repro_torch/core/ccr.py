"""The closed forms of the paper's traffic accounting that the port's
planners call, forward and backward (the JAX package's ``core/ccr.py``
holds the full Eqs. 1-14).

Conventions (paper Sec. 1.2.2): a "word" is one element (4 B single
precision, 8 B double precision).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Word-granular traffic of one layer execution under one algorithm."""

    macs: int  # multiply-accumulates
    main_loads: int  # words loaded from main (off-chip) memory
    main_stores: int  # words stored to main memory


def matmul_block_traffic(*, m: int, n: int, k: int, block_m: int,
                         block_n: int, block_k: int) -> Traffic:
    """Closed form of the blocked-matmul walk on the padded problem: an x
    block and a w block per (i, j, kk) step, one output block store per
    (i, j) — x re-streams once per output stack, w once per m-block (Alg 5's
    Eqs. (12)-(13) when one m-block covers the batch)."""
    mp = math.ceil(m / block_m) * block_m
    np_ = math.ceil(n / block_n) * block_n
    kp = math.ceil(k / block_k) * block_k
    loads = (np_ // block_n) * mp * kp + (mp // block_m) * kp * np_
    stores = mp * np_
    return Traffic(macs=mp * np_ * kp, main_loads=loads, main_stores=stores)


def conv_im2col_traffic(*, H_O: int, W_O: int, F: int, S: int, d_in: int,
                        d_out: int, block_h: int, block_m: int, block_n: int,
                        block_k: int, pool: int = 1, batch: int = 1) -> Traffic:
    """im2col-GEMM conv traffic, strip by strip.

    Each strip of ``block_h`` output rows expands its receptive fields into
    a patch matrix of ``batch * rows * W_O`` rows by ``F*F*d_in`` columns and
    multiplies it by the reshaped filter matrix with the blocked GEMM.  Every
    patch word is charged (the ``F*F/S**2`` read amplification, padding
    pixels included).  With ``pool > 1`` the unfused pool re-reads each
    window and stores the pooled plane.
    """
    k = F * F * d_in
    loads = stores = macs = 0
    for h0 in range(0, H_O, block_h):
        rows = min(block_h, H_O - h0)
        t = matmul_block_traffic(m=batch * rows * W_O, n=d_out, k=k,
                                 block_m=block_m, block_n=block_n,
                                 block_k=block_k)
        loads += t.main_loads
        stores += t.main_stores
        macs += t.macs
    if pool > 1:
        pooled = (H_O // pool) * (W_O // pool)
        loads += batch * pooled * pool * pool * d_out
        stores += batch * pooled * d_out
    return Traffic(macs=macs, main_loads=loads, main_stores=stores)


def grid_steps(grid) -> int:
    """Sequential steps of a plain software-pipelined grid: one step per
    grid point plus one pipeline-fill step."""
    steps = 1
    for g in grid:
        steps *= g
    return steps + 1



def conv_dgrad_fused_steps(*, H_I: int, d_in: int, block_h: int,
                           block_do: int, batch: int = 1) -> int:
    """Critical-path steps of the fused-epilogue dgrad variant.  The d_out
    stream is folded inside each grid step (on the H100: the conv kernel's
    double-buffered d_in loop), so the grid walks only (batch, dX strip,
    dX channel stack); plus one pipeline-fill step and one step for the
    mask-scatter prologue that rebuilds the full-rate dY."""
    n_h = -(-H_I // block_h)
    n_do = -(-d_in // block_do)
    return batch * n_h * n_do + 2


def conv_wgrad_steps(*, H_O: int, d_in: int, d_out: int, block_h: int,
                     block_di: int, block_do: int, batch: int = 1,
                     pipelined: bool = False) -> int:
    """Critical-path steps of the wgrad kernel.  The direct grid walks
    (d_i block, d_o stack, batch, strip) + fill; the pipelined variant
    folds the (batch, strip) accumulation sweep into each (d_i, d_o) step
    behind double-buffered strip copies, leaving n_di * n_do steps."""
    n_di = -(-d_in // block_di)
    n_do = -(-d_out // block_do)
    n_h = -(-H_O // block_h)
    inner = 1 if pipelined else batch * n_h
    return n_di * n_do * inner + 1


def epilogue_scatter_traffic(*, H_O: int, W_O: int, d_out: int, pool: int,
                             batch: int = 1, in_bytes: int = 4) -> Traffic:
    """The fused epilogue VJP's scatter pass: read the pooled gradient and
    the int8 pool-argmax/ReLU mask (charged in words: ``in_bytes`` mask
    bytes pack into one word), store the full-rate dY that the dgrad and
    wgrad kernels then stream."""
    pooled = batch * (H_O // pool) * (W_O // pool) * d_out
    loads = pooled + -(-pooled // in_bytes)  # pooled dY + packed int8 mask
    stores = batch * H_O * W_O * d_out  # scattered full-rate dY
    return Traffic(macs=0, main_loads=loads, main_stores=stores)
