"""Plain PyTorch oracle for flash attention (full / causal / sliding-window,
GQA), the JAX package's ``ref.py`` in PyTorch."""

import torch


def mask_logits(s, q_ids, k_ids, *, causal: bool, window: int | None):
    """Apply causal / sliding-window masking to logits ``s`` [..., Sq, Skv]."""
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask &= k_ids[None, :] <= q_ids[:, None]
    if window is not None:
        mask &= q_ids[:, None] - k_ids[None, :] < window
    return s.masked_fill(~mask, -1e30)


def attention_ref(q, k, v, *, causal=True, window=None, scale=None, out_dtype=None,
                  q_off: int = 0):
    """Dense softmax attention.

    ``q``: [B, Hq, Sq, D]; ``k``/``v``: [B, Hkv, Skv, D] with Hkv | Hq (GQA);
    query row ``i`` sits at position ``q_off + i``.
    A row whose mask admits no key spreads uniform weight (the kernel
    writes 0 there instead).
    """
    out_dtype = out_dtype or q.dtype
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D**-0.5
    group = Hq // Hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    q_ids = torch.arange(Sq, device=q.device) + q_off
    k_ids = torch.arange(Skv, device=q.device)
    s = mask_logits(s, q_ids, k_ids, causal=causal, window=window)
    p = torch.softmax(s, dim=-1)  # exp(s - max) / sum, as the JAX oracle writes it
    return torch.matmul(p, v.float()).to(out_dtype)
