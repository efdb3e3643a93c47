from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import attention_op, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_op", "attention_ref", "flash_attention", "flash_attention_kernel"]
