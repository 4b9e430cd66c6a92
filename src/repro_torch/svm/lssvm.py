"""Least-squares SVM trainer (Suykens & Vandewalle 1999).

LS-SVMs solve the KKT linear system

    [ 0      y^T          ] [ b     ]   [ 0 ]
    [ y   Omega + I/reg_c ] [ alpha ] = [ 1 ]

with Omega_ij = y_i y_j K(x_i, x_j). Every training point gets a nonzero
alpha (n_sv = n_train): the paper's §3/§5 regime, where the collapse
compresses most. A copy of ``repro.svm.lssvm``: the (n+1)^2 system is
solved in f32 with ``torch.linalg.solve`` on the tensors' device, as
``repro`` leaves it to XLA's solver.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rbf import SVMModel, rbf_kernel


def as_training_tensors(X, y, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """X and y as f32 tensors: on X's device when X is a tensor, else on
    ``device.resolve(device)`` (CUDA unless the caller says)."""
    dev = X.device if isinstance(X, torch.Tensor) else _device.resolve(device)

    def f32(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return a.to(device=dev, dtype=torch.float32)

    return f32(X), f32(y)


def solve_kkt(K: torch.Tensor, y: torch.Tensor, reg_c):
    """(b, alpha) of the LS-SVM system for the kernel matrix K (n, n) and
    labels y (n,) in {-1, +1}."""
    n = K.shape[0]
    A = torch.zeros((n + 1, n + 1), dtype=K.dtype, device=K.device)
    A[0, 1:] = y
    A[1:, 0] = y
    A[1:, 1:] = (y[:, None] * y[None, :]) * K
    A[1:, 1:] += torch.eye(n, dtype=K.dtype, device=K.device) / float(reg_c)
    rhs = torch.ones((n + 1,), dtype=K.dtype, device=K.device)
    rhs[0] = 0.0
    sol = torch.linalg.solve(A, rhs)
    return sol[0], sol[1:]


def train_lssvm(X, y, gamma, reg_c, *, device=None) -> SVMModel:
    """Train a binary LS-SVM classifier.

    Args:
      X: (n, d) training rows.
      y: (n,) labels in {-1, +1}.
      gamma: RBF kernel parameter.
      reg_c: regularization constant (larger = less regularization).
      device: where numpy inputs go (tensors stay on their device).

    Returns:
      SVMModel with n_sv == n.
    """
    X, y = as_training_tensors(X, y, device)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=X.device)
    b, alpha = solve_kkt(rbf_kernel(X, X, gamma), y, reg_c)
    return SVMModel(X=X, alpha_y=alpha * y, b=b, gamma=gamma)
