"""PyTorch/CUDA port of the JAX package ``repro`` for the NVIDIA H100.

The layouts at the public API are ``repro``'s; kernels are hand-written
CUDA (``kernels/csrc``) behind the same plan layer.  Entry points run on the
card unless given CPU tensors, which run each kernel's plain version.
"""
