from repro_torch.kernels.fwht.kernel import (
    KERNEL,
    KERNEL_Q8,
    MAX_DD,
    fastfood_score_cuda,
    fastfood_score_q8_cuda,
    fastfood_score_q8_torch,
    fastfood_score_torch,
)
from repro_torch.kernels.fwht.ref import (
    fastfood_project,
    fastfood_score_q8_ref,
    fastfood_score_ref,
    fwht,
    fwht_kron,
)

__all__ = [
    "KERNEL",
    "KERNEL_Q8",
    "MAX_DD",
    "fastfood_project",
    "fastfood_score_cuda",
    "fastfood_score_q8_cuda",
    "fastfood_score_q8_ref",
    "fastfood_score_q8_torch",
    "fastfood_score_ref",
    "fastfood_score_torch",
    "fwht",
    "fwht_kron",
]
