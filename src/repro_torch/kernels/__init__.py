"""Hand-written Hopper kernels and their plain PyTorch twins.

``quadform`` (B1, B3), ``rbf_pred`` (B2), ``rff_score`` (B4, B5),
``fwht`` (B6, B7), ``maclaurin_attn`` (B8) and ``flash_attn`` (B9) mirror
the packages of the same names in ``repro.kernels``; ``build`` compiles
``csrc/*.cu`` with nvcc at first use and binds the C entry points with
ctypes. Importing this package imports every kernel package, so
``build.KERNELS`` always lists all nine kernels.
"""

from repro_torch.kernels import (  # noqa: F401  (registers every kernel)
    flash_attn,
    fwht,
    maclaurin_attn,
    quadform,
    rbf_pred,
    rff_score,
)
