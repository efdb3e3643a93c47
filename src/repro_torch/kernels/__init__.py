"""The port's hand-written CUDA kernels and their plain PyTorch versions."""
