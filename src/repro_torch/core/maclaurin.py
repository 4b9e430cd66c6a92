"""Second-order Maclaurin approximation of RBF kernel expansions (§3).

Collapses f(z) = sum_i alpha_i y_i exp(-gamma ||x_i - z||^2) + b into the
fixed-size quadratic form (Eq 3.8)

    f_hat(z) = exp(-gamma ||z||^2) (c + v^T z + z^T M z) + b

with (Eq 3.7, matrix form):

    c = sum_i alpha_y_i exp(-gamma ||x_i||^2)
    v = X^T w,   w_i = 2 gamma   alpha_y_i exp(-gamma ||x_i||^2)
    M = X^T D X, D_ii = 2 gamma^2 alpha_y_i exp(-gamma ||x_i||^2)

Construction is one large product per head (left to ``torch.matmul``, as
``repro`` left it to XLA); prediction is O(d^2) per row, independent of
n_sv, through kernel B1.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend
from repro_torch.core.rbf import SVMModel, decision_function


@dataclasses.dataclass(frozen=True)
class ApproxModel:
    """The approximated model: three scalars, a d-vector and a d x d matrix
    (each with a leading head axis K when built from a (K, n_sv) model).

    ``max_sv_sq_norm`` stores ||x_M||^2 of the max-norm SV so the validity
    bound (Eq 3.11) can be checked at prediction time for free.
    """

    c: torch.Tensor
    v: torch.Tensor  # (d,) or (K, d)
    M: torch.Tensor  # (d, d) or (K, d, d), symmetric
    b: torch.Tensor
    gamma: torch.Tensor
    max_sv_sq_norm: torch.Tensor

    @property
    def d(self) -> int:
        return self.v.shape[-1]

    def num_parameters(self) -> int:
        """Stored scalars: c, v, M, b, gamma, ||x_M||^2 (Table-3 accounting)."""
        return self.v.numel() + self.M.numel() + 4

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def approximate(model: SVMModel) -> ApproxModel:
    """Build (c, v, M) from an exact model; cost O(n_sv d^2) per head.

    ``alpha_y`` (n_sv,) gives one head; (K, n_sv) gives K heads stacked on
    a leading axis (``repro`` vmaps over heads; here the head axis is
    written out).
    """
    X, ay, gamma = model.X, model.alpha_y, model.gamma
    sv_sq_norms = (X * X).sum(-1)  # (n_sv,)
    base = ay * torch.exp(-gamma * sv_sq_norms)  # (..., n_sv)
    c = base.sum(-1)
    v = (2.0 * gamma * base) @ X  # (..., d)
    dvals = 2.0 * gamma**2 * base
    if dvals.ndim == 1:
        M = (X.T * dvals) @ X
    else:
        M = torch.stack([(X.T * dk) @ X for dk in dvals])  # X^T D_k X per head
    msq = sv_sq_norms.max()
    return ApproxModel(c=c, v=v, M=M, b=model.b, gamma=gamma, max_sv_sq_norm=msq)


def _as_heads(model: ApproxModel):
    """One ApproxModel viewed as a K=1 stack for the fused path."""
    v = model.v
    one = lambda x: torch.as_tensor(x, dtype=v.dtype, device=v.device).reshape(1)
    return (
        model.M[None].contiguous(),
        model.v[None].contiguous(),
        one(model.c),
        one(model.b),
        one(model.gamma),
        one(model.max_sv_sq_norm),
    )


def approx_decision_function(model: ApproxModel, Z: torch.Tensor) -> torch.Tensor:
    """f_hat(Z) per Eq 3.8. O(d^2) per row."""
    scores, _, _ = backend.quadform_heads(Z, *_as_heads(model))
    return scores[:, 0]


def approx_decision_function_checked(model: ApproxModel, Z: torch.Tensor):
    """f_hat(Z) plus the per-instance validity flag of Eq 3.11.

    valid[i] == True guarantees every term in the linear combination had
    relative error < 3.05% (conservative, via Cauchy-Schwarz).
    """
    scores, _, valid = backend.quadform_heads(Z, *_as_heads(model))
    return scores[:, 0], valid[:, 0]


def approx_predict_labels(model: ApproxModel, Z: torch.Tensor) -> torch.Tensor:
    return torch.where(approx_decision_function(model, Z) >= 0, 1, -1)


def approx_model_bytes(model: ApproxModel) -> int:
    """In-memory size of the approximated model (Table-3 analogue)."""
    return sum(t.numel() * t.element_size() for t in model.tensors())


def hybrid_decision_function(approx: ApproxModel, exact: SVMModel, Z: torch.Tensor):
    """Approx fast path, exact values where Eq 3.11 fails.

    Returns (values, used_fast_path mask). Dense like ``repro``'s: the exact
    pass prices at the full batch; the serving engine re-scores only the
    violating rows.
    """
    f_hat, valid = approx_decision_function_checked(approx, Z)
    return torch.where(valid, f_hat, decision_function(exact, Z)), valid
