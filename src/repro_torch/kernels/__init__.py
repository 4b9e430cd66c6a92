"""Hand-written Hopper kernels and their plain PyTorch twins.

``quadform``, ``rbf_pred``, ``rff_score`` and ``fwht`` mirror the packages of the
same names in ``repro.kernels``; ``build`` compiles ``csrc/*.cu`` with
nvcc at first use and binds the C entry points with ctypes.
"""
