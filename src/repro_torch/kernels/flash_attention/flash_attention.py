"""The flash-attention forward kernel (``csrc/flash_attention.cu``): launch
wrapper and plain version.

Replaces ``repro/kernels/flash_attention/flash_attention.py::_fa_kernel``:
one thread block per (batch x query head, q block), the KV sequence a loop
inside the block over the blocks the causal/window skips admit, each warp
owning whole rows of the q block, online softmax with f32 (m, l) and
accumulator, GQA by ``kv head = head // group``,
``q_len``/``kv_len`` padding masks, and rows with no visible key written as
0.  Operands are ``[B*H, S, D]`` with the heads flattened into the batch and
the sequences padded to the blocks (``ops.flash_attention`` does both).
``q_off`` is the position of the first query row (a rank's slice of a
sequence-parallel query sequence): row ``i`` sits at ``q_off + i`` for the
causal and window masks and for the block skips.

q, k and v are all f32 or all bf16 (``repro_flash_attention_f32`` /
``_bf16``): the scores, softmax statistics, probabilities and accumulator
are f32 and the output takes q's dtype, as ``_fa_kernel`` upcasts q/k/v
and writes ``q.dtype``.  Both routes are built for head dims 32, 64, 128
and 256, each at the blocks ``AttentionPlanner`` picks on the H100 at the
operands' element size (:data:`MAX_BLOCKS`, :data:`MAX_BLOCKS_BF16`): at
two bytes an element the q block doubles at D = 128 and 256.

Two kernels (:func:`flash_template`): f32 runs on the CUDA cores ("fma");
bf16 runs on the tensor cores ("wgmma": S = Q·Kᵀ and P·V as ``wgmma``, K
and V fed by TMA, P as two bf16 terms so that it stays f32-accurate) at
block_q 64 or 128 and block_kv a multiple of 16 up to the bf16 maxima,
every planned bf16 block among them, and on the CUDA cores at any other
bf16 block.  The launch passes the choice to the C entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.machine import H100
from repro_torch.plan.registry import CudaKernel, one_dtype

# Head dims the kernel is built for, and each one's largest (block_q, block_kv):
# the blocks AttentionPlanner picks on the H100 at each.
MAX_BLOCKS = {32: (128, 128), 64: (128, 128), 128: (64, 64), 256: (32, 32)}
# The same for bf16 operands (the planner's picks at in_bytes=2).
MAX_BLOCKS_BF16 = {32: (128, 128), 64: (128, 128), 128: (128, 64), 256: (64, 32)}
MAX_GRID_Y = 65535  # Sq / block_q rides the grid's y axis
FLASH_TEMPLATES = ("fma", "wgmma")  # the C entry points' `tmpl` codes
WGMMA_ROWS, WGMMA_KEYS = 64, 16  # the wgmma kernel's block_q and block_kv multiples
_NEG = -1e30


def smem_bytes(block_q: int, block_kv: int, head_dim: int, in_bytes: int = 4) -> int:
    """Shared memory one block allocates (== AttentionPlanner's H100 budget
    term at ``in_bytes``): the q tile and two stages of the K and V tiles
    at ``in_bytes`` an element, the f32 probability tile in the room of
    the planner's second q stage and f32 accumulator, each row's (m, l)."""
    return (2 * in_bytes * (block_q * head_dim + 2 * block_kv * head_dim)
            + 4 * block_q * head_dim + 8 * block_q)


def max_blocks(dtype: torch.dtype) -> dict:
    """Head dim -> the largest (block_q, block_kv) built for ``dtype``."""
    return MAX_BLOCKS_BF16 if dtype == torch.bfloat16 else MAX_BLOCKS


def supported_blocks(block_q: int, block_kv: int, head_dim: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """The blocks the kernel takes for ``dtype`` operands: D in
    :func:`max_blocks`, blocks multiples of 8 up to the instantiation's
    maxima, within one block's shared memory."""
    built = max_blocks(dtype)
    if head_dim not in built:
        return False
    mq, mkv = built[head_dim]
    in_bytes = 2 if dtype == torch.bfloat16 else 4
    return (8 <= block_q <= mq and block_q % 8 == 0
            and 8 <= block_kv <= mkv and block_kv % 8 == 0
            and smem_bytes(block_q, block_kv, head_dim, in_bytes) <= H100.local_mem_bytes)


def flash_template(block_q: int, block_kv: int, head_dim: int,
                   dtype: torch.dtype = torch.float32) -> str:
    """Which kernel a launch with these blocks, head dim and operand
    ``dtype`` runs: "wgmma" (the tensor cores) for bf16 at a block_q that
    is a multiple of :data:`WGMMA_ROWS` (one warpgroup each) and a
    block_kv a multiple of :data:`WGMMA_KEYS`, up to
    :data:`MAX_BLOCKS_BF16`; else "fma" (the CUDA cores).  The launch
    passes this choice to the C entry point (:data:`FLASH_TEMPLATES`'
    index), which dispatches on it."""
    if dtype != torch.bfloat16 or head_dim not in MAX_BLOCKS_BF16:
        return "fma"
    mq, mkv = MAX_BLOCKS_BF16[head_dim]
    tc = (0 < block_q <= mq and block_q % WGMMA_ROWS == 0
          and 0 < block_kv <= mkv and block_kv % WGMMA_KEYS == 0)
    return "wgmma" if tc else "fma"


def _check(q, k, v, *, block_q, block_kv, window, q_len, kv_len, q_off=0):
    """The function's contract: flattened heads, whole blocks, lengths
    within the padded sequences.  (The head dims and block maxima the
    kernel is built for are checked at launch.)"""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    one_dtype("flash_attention", q=q, k=k, v=v)
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if bhq % bhkv:
        raise ValueError(f"flash_attention: {bhkv} kv heads do not divide {bhq}")
    if block_q <= 0 or block_kv <= 0 or sq % block_q or skv % block_kv:
        raise ValueError(f"flash_attention: sequences ({sq}, {skv}) are not "
                         f"multiples of the blocks ({block_q}, {block_kv})")
    if not (0 <= q_len <= sq and 0 <= kv_len <= skv):
        raise ValueError(f"flash_attention: lengths ({q_len}, {kv_len}) exceed "
                         f"the padded sequences ({sq}, {skv})")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q_off < 0:
        raise ValueError(f"flash_attention: q_off must be >= 0, got {q_off}")
    return bhq, bhkv, sq, skv, d


def flash_attention_plain(q, k, v, *, block_q: int, block_kv: int, scale: float,
                          causal: bool, window: int | None, q_len: int, kv_len: int,
                          q_off: int = 0):
    """The kernel's function in plain PyTorch (same contract, same checks):
    dense f32 attention with the padding, causal and window masks, query
    row ``i`` at position ``q_off + i``; a row with no visible key is 0;
    the result rounded once to q's dtype.  On the card it needs TF32 off
    to be an f32 reference."""
    bhq, bhkv, sq, skv, _ = _check(q, k, v, block_q=block_q, block_kv=block_kv,
                                   window=window, q_len=q_len, kv_len=kv_len, q_off=q_off)
    group = bhq // bhkv
    kk = k.float().repeat_interleave(group, dim=0)
    vv = v.float().repeat_interleave(group, dim=0)
    s = torch.matmul(q.float(), kk.transpose(1, 2)) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    q_ids = rows + q_off
    k_ids = torch.arange(skv, device=q.device)[None, :]
    mask = (rows < q_len) & (k_ids < kv_len)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        mask &= q_ids - k_ids < window
    s = s.masked_fill(~mask, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, vv) / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)


def admitted_pairs(q_len: int, kv_len: int, causal: bool, window: int | None,
                   q_off: int = 0) -> int:
    """The (query, key) pairs of one head the masks admit: query row ``i``
    at position ``q_off + i`` sees keys ``j < kv_len`` with ``j <= q_off +
    i`` (causal) and ``q_off + i - j < window``."""
    pos = np.arange(q_len, dtype=np.int64) + q_off
    hi = np.minimum(pos, kv_len - 1) if causal else np.full(q_len, kv_len - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(q_len, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(q, k, v, *, block_q: int, block_kv: int, scale: float,
                         causal: bool, window: int | None, q_len: int, kv_len: int,
                         q_off: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: 4·D FLOP (QKᵀ and PV) per admitted (q, k)
    pair of every query head; the valid rows of Q, K and V read once and
    the output's (in q's dtype) written once, each at its element size."""
    del block_q, block_kv, scale
    bhq, d, bhkv = q.shape[0], q.shape[2], k.shape[0]
    pairs = admitted_pairs(q_len, kv_len, causal, window, q_off)
    return (4.0 * bhq * pairs * d,
            float(d * (2 * q.element_size() * bhq * q_len
                       + (k.element_size() + v.element_size()) * bhkv * kv_len)))


def _launch(kernel: CudaKernel, q, k, v, *, block_q: int, block_kv: int, scale: float,
            causal: bool, window: int | None, q_len: int, kv_len: int, q_off: int = 0):
    bhq, bhkv, sq, skv, d = _check(q, k, v, block_q=block_q, block_kv=block_kv,
                                   window=window, q_len=q_len, kv_len=kv_len, q_off=q_off)
    dtype = kernel.operand_dtype(q=q, k=k, v=v)
    built = max_blocks(dtype)
    if d not in built:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{sorted(built)} for {dtype} operands, got {d}")
    if not supported_blocks(block_q, block_kv, d, dtype):
        raise ValueError(f"flash_attention kernel does not take blocks "
                         f"(q={block_q}, kv={block_kv}) at head_dim {d} ({dtype})")
    if sq // block_q > MAX_GRID_Y:
        raise ValueError(f"flash_attention Sq/block_q = {sq // block_q} exceeds the grid")
    out = torch.empty_like(q)
    kernel.run(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
               ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
               bhq, bhkv, sq, skv, d, block_q, block_kv, q_len, kv_len, int(causal),
               -1 if window is None else window, int(q_off),
               FLASH_TEMPLATES.index(flash_template(block_q, block_kv, d, dtype)),
               ctypes.c_float(scale), dtype=dtype)
    return out


flash_attention_kernel = CudaKernel(
    "flash_attention", source="flash_attention", symbol="repro_flash_attention_f32",
    bf16_symbol="repro_flash_attention_bf16",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_float,
                                                            ctypes.c_void_p],
    launch=_launch, plain=flash_attention_plain, cost=flash_attention_cost,
)
