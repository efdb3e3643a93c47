from repro_torch.kernels.matmul.matmul import matmul_kernel
from repro_torch.kernels.matmul.ops import fc_matmul, matmul_op
from repro_torch.kernels.matmul.ref import fc_matmul_ref

__all__ = ["fc_matmul", "fc_matmul_ref", "matmul_kernel", "matmul_op"]
