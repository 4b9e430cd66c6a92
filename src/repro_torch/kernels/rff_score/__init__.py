from repro_torch.kernels.rff_score.kernel import (
    KERNEL,
    KERNEL_Q8,
    rff_score_cuda,
    rff_score_q8_cuda,
    rff_score_q8_torch,
    rff_score_torch,
)
from repro_torch.kernels.rff_score.ref import rff_score_ref

__all__ = [
    "KERNEL",
    "KERNEL_Q8",
    "rff_score_cuda",
    "rff_score_q8_cuda",
    "rff_score_q8_torch",
    "rff_score_ref",
    "rff_score_torch",
]
