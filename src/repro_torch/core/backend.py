"""The serving primitives, each a hand-written CUDA kernel on the card.

  * ``quadform_heads`` — the collapsed quadratic form (Eq 3.8) fused over
    K heads, with ||z||^2 and the Eq 3.11 mask (kernel B1);
  * ``rbf_scores`` — the exact RBF expansion (Eq 3.2), the engine's
    accuracy fallback (kernel B2);
  * ``family_scores`` — a ``CompiledArtifact`` through its family's
    primitive.

``repro``'s backend picked Pallas or XLA per process. Here the choice
follows the tensors: CUDA tensors launch the kernel (or raise, when it
cannot be built or launched), CPU tensors compute with the plain twins
``quadform_heads_torch`` / ``rbf_scores_torch``. There is no switch that
sends CUDA tensors to the plain versions.

``config=None`` resolves the ``TileConfig`` for the operand shapes from
the tuning registry.
"""

from __future__ import annotations

from repro_torch.kernels.common import TileConfig, tuning
from repro_torch.kernels.quadform.kernel import (
    quadform_heads_cuda,
    quadform_heads_torch,
)
from repro_torch.kernels.rbf_pred.kernel import rbf_scores_cuda, rbf_scores_torch

__all__ = [
    "family_scores",
    "quadform_heads",
    "quadform_heads_torch",
    "rbf_scores",
    "rbf_scores_torch",
]


def quadform_heads(Z, M_all, V, c, b, gamma, msq, *, config: TileConfig | None = None):
    """Fused K-head scores.

    Z: (n, d); M_all: (K, d, d); V: (K, d); c/b/gamma/msq: (K,).
    Returns (scores (n, K), z_sq (n,), valid (n, K)) where valid is the
    per-head Eq 3.11 mask.
    """
    if config is None:
        config = tuning.lookup(
            "quadform",
            tuning.shape_key(
                d=Z.shape[1], k=M_all.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return quadform_heads_cuda(Z, M_all, V, c, b, gamma, msq, config=config)


def rbf_scores(Z, X, alpha_y, gamma, b, *, config: TileConfig | None = None):
    """Exact decision values f(Z) = sum_i a_i K(x_i, z) + b.

    ``alpha_y`` (m,) with a scalar ``b`` gives (n,); (K, m) with ``b``
    (K,) gives (n, K), every distance shared by the K heads.
    """
    if config is None:
        config = tuning.lookup(
            "rbf_pred",
            tuning.shape_key(d=Z.shape[1], m=X.shape[0], n=tuning.bucket(Z.shape[0])),
        )
    return rbf_scores_cuda(Z, X, alpha_y, gamma, b, config=config)


def family_scores(artifact, Z, *, config: TileConfig | None = None):
    """Score a ``CompiledArtifact`` through its family's serving primitive.

    Returns ``(scores (n, K), valid_rows (n,))``.
    """
    from repro_torch.core import families

    return families.score_artifact(artifact, Z, config=config)
