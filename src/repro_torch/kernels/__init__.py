"""Hand-written Hopper kernels and their plain PyTorch twins.

``quadform`` and ``rbf_pred`` mirror ``repro.kernels.quadform`` and
``repro.kernels.rbf_pred``; ``build`` compiles ``csrc/*.cu`` with nvcc at
first use and binds the C entry points with ctypes.
"""
