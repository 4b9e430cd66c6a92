"""Plain-torch oracle for the exact RBF prediction kernel."""

from __future__ import annotations

import torch


def rbf_predict_ref(Z, X, alpha_y, gamma, b):
    """f(Z) = sum_i alpha_y_i exp(-gamma ||x_i - z||^2) + b.

    Z: (n, d), X: (m, d), alpha_y: (m,), gamma/b scalars. Returns (n,).
    """
    z_sq = (Z * Z).sum(-1)[:, None]
    x_sq = (X * X).sum(-1)[None, :]
    d2 = torch.clamp(z_sq + x_sq - 2.0 * (Z @ X.T), min=0.0)
    return torch.exp(-gamma * d2) @ alpha_y + b
