"""One-vs-rest multiclass wrapper (the paper's mnist/sensit protocol).

The per-class models share X, so the collapse gives one (c, v, M) triple
per class, still O(K d^2) in all, whatever n_sv. Prediction is fused
across heads: the exact scores run through ``backend.rbf_scores``
(kernel B2 on the card, every distance shared by the K heads) and the
collapsed ones through ``backend.quadform_heads`` (kernel B1). A copy of
``repro.svm.multiclass``; its vmap over classes is a loop over one shared
kernel matrix.
"""

from __future__ import annotations

import torch

from repro_torch.core import backend
from repro_torch.core.families.base import as_batch
from repro_torch.core.maclaurin import ApproxModel, approximate
from repro_torch.core.rbf import SVMModel, rbf_kernel
from repro_torch.svm.lssvm import as_training_tensors, solve_kkt


def binary_labels(y_multi: torch.Tensor, positive_class: int) -> torch.Tensor:
    """'class k vs others' labels in {-1, +1}."""
    return torch.where(y_multi == positive_class, 1.0, -1.0)


def train_one_vs_rest(
    X, y_multi, num_classes: int, gamma, reg_c, *, device=None
) -> SVMModel:
    """Train K binary LS-SVMs on one shared X and kernel matrix.

    Returns an SVMModel whose alpha_y has shape (K, n) and b shape (K,).
    """
    X, y_multi = as_training_tensors(X, y_multi, device)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=X.device)
    K_mat = rbf_kernel(X, X, gamma)
    alpha_y, b = [], []
    for k in range(num_classes):
        yk = binary_labels(y_multi, k)
        bk, alpha = solve_kkt(K_mat, yk, reg_c)
        alpha_y.append(alpha * yk)
        b.append(bk)
    return SVMModel(X=X, alpha_y=torch.stack(alpha_y), b=torch.stack(b), gamma=gamma)


def ovr_scores(model: SVMModel, Z) -> torch.Tensor:
    """Exact per-class decision values (n, K), one pass for all heads."""
    Z = as_batch(Z, model.X.device)
    return backend.rbf_scores(
        Z, model.X.contiguous(), model.alpha_y.contiguous(), model.gamma, model.b
    )


def ovr_predict(model: SVMModel, Z) -> torch.Tensor:
    """argmax over per-class decision values."""
    return torch.argmax(ovr_scores(model, Z), dim=-1)


def approximate_ovr(model: SVMModel) -> ApproxModel:
    """Collapse every class head (K-stacked; gamma and ||x_M||^2 repeated
    per head, as ``repro``'s vmap gives them)."""
    approx = approximate(model)
    k = model.alpha_y.shape[0]
    return ApproxModel(
        c=approx.c,
        v=approx.v,
        M=approx.M,
        b=approx.b,
        gamma=approx.gamma.reshape(()).expand(k).contiguous(),
        max_sv_sq_norm=approx.max_sv_sq_norm.reshape(()).expand(k).contiguous(),
    )


def approx_ovr_scores(approx: ApproxModel, Z) -> torch.Tensor:
    """Fused K-head collapsed scores (n, K)."""
    Z = as_batch(Z, approx.M.device)
    scores, _, _ = backend.quadform_heads(
        Z,
        approx.M.contiguous(),
        approx.v.contiguous(),
        approx.c,
        approx.b,
        approx.gamma,
        approx.max_sv_sq_norm,
    )
    return scores


def approx_ovr_predict(approx: ApproxModel, Z) -> torch.Tensor:
    return torch.argmax(approx_ovr_scores(approx, Z), dim=-1)


def compile_ovr(model: SVMModel, family: str = "maclaurin", **opts):
    """Compile an OvR ensemble into a servable K-head artifact (any family,
    any of its options); pass it to ``SVMEngine`` or ``save`` it."""
    from repro_torch.core import families

    return families.get_family(family).compile(model, **opts)
