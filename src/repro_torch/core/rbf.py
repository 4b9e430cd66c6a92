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


def predict_labels(model: SVMModel, Z: torch.Tensor) -> torch.Tensor:
    """Binary labels in {-1, +1}."""
    return torch.where(decision_function(model, Z) >= 0, 1, -1)


def model_bytes(model: SVMModel) -> int:
    """In-memory size of the exact model (for the Table-3 analogue)."""
    return sum(t.numel() * t.element_size() for t in model.tensors())
