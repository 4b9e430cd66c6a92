"""Plain-torch oracles for the quadratic-form prediction kernel (Eq 3.8).

``quadform_predict_ref`` is the single-head oracle; ``quadform_heads_ref``
is the deliberately unfused multi-head oracle (K independent single-head
evaluations), the slow but obviously correct reference for the fused
paths.
"""

from __future__ import annotations

import torch


def eq311_valid(z_sq: torch.Tensor, gamma: torch.Tensor, msq: torch.Tensor):
    """Per-head Eq 3.11 mask (n, K): valid iff ||x_M||^2 ||z||^2 < 1/(16 g^2).

    z_sq: (n,), gamma/msq: (K,). Strict ``<``; the 1e-30 floor on gamma^2
    guards a degenerate gamma == 0 head without producing inf. The CUDA
    kernel's epilogue computes the same expression in f32.
    """
    rhs = 0.0625 / torch.clamp(gamma * gamma, min=1e-30)
    return msq[None, :] * z_sq[:, None] < rhs[None, :]


def quadform_predict_ref(Z, M, v, c, b, gamma):
    """f_hat(Z) = exp(-gamma ||z||^2)(c + v^T z + z^T M z) + b.

    Z: (n, d), M: (d, d), v: (d,). Returns (f_hat (n,), z_sq (n,)).
    """
    z_sq = (Z * Z).sum(-1)
    g_hat = c + Z @ v + ((Z @ M) * Z).sum(-1)
    return torch.exp(-gamma * z_sq) * g_hat + b, z_sq


def quadform_heads_ref(Z, M_all, V, c, b, gamma, msq):
    """Per-head oracle: M_all (K, d, d), V (K, d), c/b/gamma/msq (K,).

    Returns (scores (n, K), z_sq (n,), valid (n, K)), each head evaluated
    on its own.
    """
    outs = [
        quadform_predict_ref(Z, M_all[k], V[k], c[k], b[k], gamma[k])
        for k in range(M_all.shape[0])
    ]
    scores = torch.stack([s for s, _ in outs], dim=1)
    z_sq = outs[0][1]
    return scores, z_sq, eq311_valid(z_sq, gamma, msq)
