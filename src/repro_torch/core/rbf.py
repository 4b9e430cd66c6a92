"""Exact RBF-kernel expansion models (Eq 3.2/3.3 of the paper).

    f(z) = sum_i  alpha_i y_i exp(-gamma ||x_i - z||^2) + b

``alpha_y = alpha * y`` is stored as one tensor, support vectors as rows
of ``X`` (n_sv, d). A K-head one-vs-rest model keeps ``alpha_y`` as
(K, n_sv) and ``b`` as (K,).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SVMModel:
    """An exact RBF kernel expansion (SVM / LS-SVM / any representer model).

    Attributes:
      X:        (n_sv, d) support vectors, one per row.
      alpha_y:  (n_sv,) or (K, n_sv) combined support values alpha_i y_i.
      b:        scalar (or (K,)) bias.
      gamma:    scalar RBF kernel parameter.
    """

    X: torch.Tensor
    alpha_y: torch.Tensor
    b: torch.Tensor
    gamma: torch.Tensor

    @property
    def n_sv(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    def num_parameters(self) -> int:
        """Stored scalars: SVs + alpha_y + b + gamma (Table-3 accounting)."""
        return self.X.numel() + self.alpha_y.numel() + 2

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def rbf_kernel(Xa: torch.Tensor, Xb: torch.Tensor, gamma) -> torch.Tensor:
    """Pairwise RBF kernel matrix K[i, j] = exp(-gamma ||a_i - b_j||^2),
    via the GEMM expansion with tiny negative distances clamped to 0."""
    sq_a = (Xa * Xa).sum(-1)[:, None]
    sq_b = (Xb * Xb).sum(-1)[None, :]
    d2 = torch.clamp(sq_a + sq_b - 2.0 * (Xa @ Xb.T), min=0.0)
    return torch.exp(-gamma * d2)


def decision_function(model: SVMModel, Z: torch.Tensor) -> torch.Tensor:
    """Exact decision values f(Z) for a batch of test rows Z (n, d)."""
    return rbf_kernel(Z, model.X, model.gamma) @ model.alpha_y + model.b


def decision_function_loops(model: SVMModel, Z: torch.Tensor) -> torch.Tensor:
    """The paper's LOOPS baseline: one support vector at a time, no GEMM.

    Deliberately naive (n_sv sequential steps), for the Table 2 ordering
    of LOOPS against BLAS; it has no kernel. Binary models only, as the
    reference's: ``alpha_y`` is (n_sv,).
    """
    if model.alpha_y.ndim != 1:
        raise ValueError(
            f"expected alpha_y of shape (n_sv,), got {model.alpha_y.shape}"
        )
    acc = torch.zeros(Z.shape[0], dtype=Z.dtype, device=Z.device)
    for xi, ai in zip(model.X, model.alpha_y):
        diff = Z - xi[None, :]
        acc = acc + ai * torch.exp(-model.gamma * (diff * diff).sum(-1))
    return acc + model.b


def predict_labels(model: SVMModel, Z: torch.Tensor) -> torch.Tensor:
    """Binary labels in {-1, +1}."""
    return torch.where(decision_function(model, Z) >= 0, 1, -1)


def model_bytes(model: SVMModel) -> int:
    """In-memory size of the exact model (for the Table-3 analogue)."""
    return sum(t.numel() * t.element_size() for t in model.tensors())
