"""Public wrapper for the flash-attention kernel — a thin registration
against the plan layer.

Blocks come from :class:`repro_torch.plan.AttentionPlanner`: the q block
with its f32 accumulator is the resident output stack, K/V stream through,
and blocks halve until the working set fits the machine.  Sequences are
zero-padded to the blocks, heads flattened into the batch and the result
sliced back, as ``repro/kernels/flash_attention/ops.py`` does.
"""

from __future__ import annotations

import torch

from repro_torch.core.machine import H100, MachineModel
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.plan import AttentionPlanner, Schedule, cuda_op, pad_dim, round_up


def _shape_args(q, k, v, *, causal=True, window=None, scale=None,
                block_q=None, block_kv=None, q_off=0):
    # The planner models a causal slice without its offset (ROADMAP queue 3).
    del v, scale, q_off  # never change blocking
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    return dict(seq_q=Sq, seq_kv=Skv, head_dim=D, n_q_heads=Hq, n_kv_heads=Hkv,
                batch=B, in_bytes=q.element_size(), block_q=block_q,
                block_kv=block_kv, causal=causal, window=window)


def _impl(q, k, v, *, schedule, causal=True, window=None, scale=None,
          block_q=None, block_kv=None, q_off=0):
    del block_q, block_kv  # consumed by the planner
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D**-0.5
    bq = min(schedule.block("block_q", 128), round_up(Sq, 8))
    bkv = min(schedule.block("block_kv", 128), round_up(Skv, 8))
    sqp, skvp = round_up(Sq, bq), round_up(Skv, bkv)
    qp = pad_dim(q, 2, sqp).reshape(B * Hq, sqp, D).contiguous()
    kp = pad_dim(k, 2, skvp).reshape(B * Hkv, skvp, D).contiguous()
    vp = pad_dim(v, 2, skvp).reshape(B * Hkv, skvp, D).contiguous()
    out = flash_attention_kernel(qp, kp, vp, block_q=bq, block_kv=bkv, scale=scale,
                                 causal=causal, window=window, q_len=Sq, kv_len=Skv,
                                 q_off=q_off)
    return out.reshape(B, Hq, sqp, D)[:, :, :Sq]


attention_op = cuda_op(
    "flash_attention", planner=AttentionPlanner, shape_args=_shape_args, impl=_impl,
    kernel=flash_attention_kernel,
)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int | None = None, scale: float | None = None,
    schedule: Schedule | None = None, block_q: int | None = None,
    block_kv: int | None = None, machine: MachineModel = H100, q_off: int = 0,
) -> torch.Tensor:
    """Blockwise attention. q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]; query
    row ``i`` sits at position ``q_off + i`` (a slice of a longer query
    sequence), key ``j`` at ``j``.

    Pads sequences to block multiples; GQA via Hkv | Hq head grouping.
    Blocking: ``schedule`` > ``block_q``/``block_kv`` pins > planner.  CPU
    tensors run the kernel's plain version, CUDA tensors the kernel.
    """
    return attention_op(q, k, v, schedule=schedule, machine=machine, causal=causal,
                        window=window, scale=scale, block_q=block_q,
                        block_kv=block_kv, q_off=q_off)
