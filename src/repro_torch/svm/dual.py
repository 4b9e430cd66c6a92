"""Box-constrained dual kernel-SVM trainer (a LIBSVM stand-in).

Solves the C-SVC dual with the bias folded into the kernel (the "K + 1"
trick, which drops the equality constraint sum alpha_i y_i = 0):

    max_alpha  1^T alpha - 1/2 alpha^T Q alpha,   0 <= alpha <= C
    Q_ij = y_i y_j (K(x_i, x_j) + 1)

by projected gradient ascent with the step 1 / lambda_max(Q), estimated
by power iteration. The bias is then b = sum_i alpha_i y_i. Many alphas
project to exactly zero, giving the paper's n_sv < n regime. A copy of
``repro.svm.dual``: each ``lax.scan`` is a Python loop of a fixed number
of steps, on the tensors' device.
"""

from __future__ import annotations

import torch

from repro_torch.core.rbf import SVMModel, rbf_kernel
from repro_torch.svm.lssvm import as_training_tensors


def _power_iter_lmax(Q: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Largest eigenvalue of PSD Q by power iteration (fixed iterations)."""
    n = Q.shape[0]
    v = torch.ones((n,), dtype=Q.dtype, device=Q.device) / n**0.5
    for _ in range(iters):
        w = Q @ v
        v = w / (torch.linalg.norm(w) + 1e-30)
    return v @ (Q @ v)


def train_svc(
    X,
    y,
    gamma,
    C,
    num_steps: int = 500,
    sv_threshold: float = 1e-6,
    *,
    device=None,
) -> tuple[SVMModel, torch.Tensor]:
    """Train a binary C-SVC.

    Returns (model, sv_mask). The model keeps all rows; ``sv_mask`` marks
    alpha > sv_threshold * C, and the alphas of the other rows are zero.
    ``compress_support`` drops those rows.
    """
    X, y = as_training_tensors(X, y, device)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=X.device)
    C = float(C)
    K = rbf_kernel(X, X, gamma) + 1.0  # bias folded into the kernel
    Q = (y[:, None] * y[None, :]) * K
    step = 1.0 / (_power_iter_lmax(Q) + 1e-12)
    alpha = torch.zeros_like(y)
    for _ in range(num_steps):
        grad = 1.0 - Q @ alpha
        alpha = torch.clamp(alpha + step * grad, 0.0, C)

    b = torch.sum(alpha * y)  # from the K + 1 trick
    sv_mask = alpha > sv_threshold * C
    # Zero the non-SVs so the dense model equals the compressed one.
    alpha = torch.where(sv_mask, alpha, 0.0)
    return SVMModel(X=X, alpha_y=alpha * y, b=b, gamma=gamma), sv_mask


def compress_support(model: SVMModel, sv_mask: torch.Tensor) -> SVMModel:
    """Drop the non-support rows."""
    return SVMModel(
        X=model.X[sv_mask].contiguous(),
        alpha_y=model.alpha_y[sv_mask].contiguous(),
        b=model.b,
        gamma=model.gamma,
    )
