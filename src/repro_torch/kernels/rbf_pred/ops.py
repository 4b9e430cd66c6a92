"""Public shim for the exact RBF prediction kernel, as the reference's
``repro.kernels.rbf_pred.ops``.

``use_pallas`` keeps the reference's name for A/B comparisons: ``True``
runs the port's wrapper of kernel B2 (``rbf_scores_cuda``: the kernel on
CUDA tensors, its plain twin on CPU tensors, nothing falling back from
the card), ``False`` the oracle of ``ref.py``. ``config`` is the port's
``TileConfig`` (``None``: the tuning default).
"""

from __future__ import annotations

from repro_torch.kernels.common import TileConfig
from repro_torch.kernels.rbf_pred.kernel import rbf_scores_cuda
from repro_torch.kernels.rbf_pred.ref import rbf_predict_ref


def rbf_predict(
    Z, X, alpha_y, gamma, b, use_pallas: bool = True, config: TileConfig | None = None
):
    """f(Z) = sum_i alpha_y_i exp(-gamma ||x_i - z||^2) + b. Z: (n, d),
    X: (m, d), alpha_y: (m,), gamma and b scalars. Returns (n,)."""
    if not use_pallas:
        return rbf_predict_ref(Z, X, alpha_y, gamma, b)
    return rbf_scores_cuda(Z, X, alpha_y, gamma, b, config=config)
