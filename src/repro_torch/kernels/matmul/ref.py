"""Plain PyTorch oracle for the FC/blocked matmul kernel."""

import torch


def fc_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """O = X @ W in f32.

    ``x``: [M, K] activations (M = batch-like dim, K = W_I^2 * D_I).
    ``w``: [K, N] filter parameters (N = D_O).
    """
    return torch.matmul(x.float(), w.float())
