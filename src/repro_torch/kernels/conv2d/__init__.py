from repro_torch.kernels.conv2d.conv2d import conv2d_kernel
from repro_torch.kernels.conv2d.im2col import conv2d_im2col
from repro_torch.kernels.conv2d.ops import conv2d, conv2d_op, conv2d_with_mask
from repro_torch.kernels.conv2d.ref import conv2d_fused_ref, conv2d_ref, maxpool_ref

__all__ = [
    "conv2d", "conv2d_fused_ref", "conv2d_im2col", "conv2d_kernel", "conv2d_op",
    "conv2d_ref", "conv2d_with_mask", "maxpool_ref",
]
