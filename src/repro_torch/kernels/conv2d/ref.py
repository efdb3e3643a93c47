"""Plain PyTorch oracles for the conv2d kernels (NHWC activations,
``[F, F, D_I, D_O]`` filters, as in the JAX package)."""

import torch
import torch.nn.functional as F


def conv2d_ref(x, f, *, stride: int = 1, padding: int = 0, out_dtype=None):
    """Direct 2D convolution (cross-correlation, CNN convention), computed
    in f32 and returned in ``out_dtype`` (default x's dtype), as
    ``repro``'s ``conv2d_ref``.

    ``x``: [H, W, D_I] or [B, H, W, D_I]; ``f``: [F, F, D_I, D_O].
    Returns [H_O, W_O, D_O] (or batched), H_O = (H + 2P - F)//S + 1.
    """
    squeeze = x.ndim == 3
    out_dtype = out_dtype or x.dtype
    if squeeze:
        x = x[None]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), f.float().permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    return y[0] if squeeze else y


def maxpool_ref(x, pool: int = 2):
    """Non-overlapping ``pool x pool`` max-pool (floor semantics) over the
    spatial dims of [..., H, W, C]."""
    *lead, H, W, C = x.shape
    Hc, Wc = H - H % pool, W - W % pool
    x = x[..., :Hc, :Wc, :]
    return x.reshape(*lead, Hc // pool, pool, Wc // pool, pool, C).amax((-4, -2))


def conv2d_fused_ref(x, f, bias=None, *, stride: int = 1, padding: int = 0,
                     relu: bool = False, pool: int = 1, out_dtype=None):
    """Oracle for the fused conv + bias + ReLU + max-pool epilogue path:
    the epilogue on the f32 conv, the result rounded once to ``out_dtype``
    (default x's dtype), as ``repro``'s ``conv2d_fused_ref``."""
    out_dtype = out_dtype or x.dtype
    y = conv2d_ref(x, f, stride=stride, padding=padding, out_dtype=torch.float32)
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    if pool > 1:
        y = maxpool_ref(y, pool)
    return y.to(out_dtype)
