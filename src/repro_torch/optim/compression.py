"""Error-feedback int8 gradient compression, the JAX package's
``optim/compression.py`` in plain PyTorch.

``compress_decompress`` quantizes a gradient tensor to int8 with a
per-tensor scale, carrying the quantization error into the next step (error
feedback keeps the compressed AdamW iterates convergent).  Rounding is
half-to-even, as ``jnp.round`` rounds.  (``int8_psum``, the all-reduce whose
wire payload is int8, waits for the sharded trainer.)
"""

from __future__ import annotations

import torch


def compress_decompress(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (decompressed gradient, new error buffer)."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def compress_tree(grads: dict, errs: dict) -> tuple[dict, dict]:
    """``compress_decompress`` over a ``{name: tensor}`` dict: (decompressed
    gradients, new error buffers)."""
    pairs = {k: compress_decompress(g, errs[k]) for k, g in grads.items()}
    return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}


def init_error_buffers(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
