from repro_torch.kernels.maclaurin_attn.kernel import (
    KERNEL,
    maclaurin_attention_cuda,
    maclaurin_attention_torch,
    route,
)
from repro_torch.kernels.maclaurin_attn.ops import maclaurin_attention
from repro_torch.kernels.maclaurin_attn.ref import (
    maclaurin_attention_ref,
    maclaurin_weights,
    softmax_attention_ref,
)

__all__ = [
    "KERNEL",
    "maclaurin_attention",
    "maclaurin_attention_cuda",
    "maclaurin_attention_ref",
    "maclaurin_attention_torch",
    "maclaurin_weights",
    "route",
    "softmax_attention_ref",
]
