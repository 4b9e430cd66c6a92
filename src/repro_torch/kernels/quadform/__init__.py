from repro_torch.kernels.quadform.kernel import (
    KERNEL,
    quadform_heads_cuda,
    quadform_heads_torch,
)
from repro_torch.kernels.quadform.ref import (
    eq311_valid,
    quadform_heads_ref,
    quadform_predict_ref,
)

__all__ = [
    "KERNEL",
    "eq311_valid",
    "quadform_heads_cuda",
    "quadform_heads_ref",
    "quadform_heads_torch",
    "quadform_predict_ref",
]
