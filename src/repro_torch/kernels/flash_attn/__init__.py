from repro_torch.kernels.flash_attn.kernel import (
    KERNEL,
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import softmax_attention_ref

__all__ = [
    "KERNEL",
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_torch",
    "softmax_attention_ref",
]
