"""Public shims for the quadratic-form prediction kernel (Eq 3.8), as the
reference's ``repro.kernels.quadform.ops``.

``use_pallas`` keeps the reference's name for A/B comparisons: ``True``
runs the port's wrapper of kernel B1 (``quadform_heads_cuda``: the kernel
on CUDA tensors, its plain twin on CPU tensors, nothing falling back from
the card), ``False`` the per-head oracle of ``ref.py``. ``config`` is the
port's ``TileConfig`` (``None``: the tuning default).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import TileConfig
from repro_torch.kernels.quadform.kernel import quadform_heads_cuda
from repro_torch.kernels.quadform.ref import quadform_heads_ref, quadform_predict_ref


def _one(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device).reshape(1)


def quadform_predict(
    Z, M, v, c, b, gamma, use_pallas: bool = True, config: TileConfig | None = None
):
    """Single head: (f_hat (n,), z_sq (n,)), the K=1 slice of the fused
    multi-head kernel."""
    if not use_pallas:
        return quadform_predict_ref(Z, M, v, c, b, gamma)
    scores, z_sq, _ = quadform_heads_cuda(
        Z,
        M[None],
        v[None],
        _one(c, Z),
        _one(b, Z),
        _one(gamma, Z),
        _one(0.0, Z),
        config=config,
    )
    return scores[:, 0], z_sq


def quadform_predict_heads(
    Z,
    M_all,
    V,
    c,
    b,
    gamma,
    msq,
    use_pallas: bool = True,
    config: TileConfig | None = None,
):
    """Fused K heads: (scores (n, K), z_sq (n,), valid (n, K)).

    ``use_pallas=False`` runs the unfused per-head oracle, the baseline
    the fused path is compared with.
    """
    if not use_pallas:
        return quadform_heads_ref(Z, M_all, V, c, b, gamma, msq)
    return quadform_heads_cuda(Z, M_all, V, c, b, gamma, msq, config=config)
