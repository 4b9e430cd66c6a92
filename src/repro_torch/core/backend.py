"""The serving primitives, each a hand-written CUDA kernel on the card.

  * ``quadform_heads`` — the collapsed quadratic form (Eq 3.8) fused over
    K heads, with ||z||^2 and the Eq 3.11 mask (kernel B1);
  * ``quadform_heads_q8`` — the same off an int8 stacked Hessian
    (kernel B3);
  * ``rbf_scores`` — the exact RBF expansion (Eq 3.2), the engine's
    accuracy fallback (kernel B2);
  * ``rff_score`` / ``rff_score_q8`` — random-Fourier-feature scores off
    f32 (kernel B4) or int8 (kernel B5) weights;
  * ``fastfood_score`` / ``fastfood_score_q8`` — the same off the
    structured (Fastfood) projection, f32 (kernel B6) or int8 (kernel B7)
    operators;
  * ``family_scores`` — a ``CompiledArtifact`` through its family's
    primitive.

``repro``'s backend picked Pallas or XLA per process. Here the choice
follows the tensors: CUDA tensors launch the kernel (or raise, when it
cannot be built or launched), CPU tensors compute with the plain twins
(``*_torch``). There is no switch that sends CUDA tensors to the plain
versions.

``config=None`` resolves the ``TileConfig`` for the operand shapes from
the tuning registry.
"""

from __future__ import annotations

from repro_torch.kernels.common import TileConfig, tuning
from repro_torch.kernels.fwht.kernel import (
    fastfood_score_cuda,
    fastfood_score_q8_cuda,
    fastfood_score_q8_torch,
    fastfood_score_torch,
)
from repro_torch.kernels.quadform.kernel import (
    quadform_heads_cuda,
    quadform_heads_q8_cuda,
    quadform_heads_q8_torch,
    quadform_heads_torch,
)
from repro_torch.kernels.rbf_pred.kernel import rbf_scores_cuda, rbf_scores_torch
from repro_torch.kernels.rff_score.kernel import (
    rff_score_cuda,
    rff_score_q8_cuda,
    rff_score_q8_torch,
    rff_score_torch,
)

__all__ = [
    "family_scores",
    "fastfood_score",
    "fastfood_score_q8",
    "fastfood_score_q8_torch",
    "fastfood_score_torch",
    "quadform_heads",
    "quadform_heads_q8",
    "quadform_heads_q8_torch",
    "quadform_heads_torch",
    "rbf_scores",
    "rbf_scores_torch",
    "rff_score",
    "rff_score_q8",
    "rff_score_q8_torch",
    "rff_score_torch",
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


def quadform_heads_q8(
    Z, M_q, col_scale, V, c, b, gamma, msq, *, config: TileConfig | None = None
):
    """Fused K-head scores off an int8 stacked Hessian.

    Z: (n, d); M_q: (K, d, d) int8; col_scale: (K, d) f32 per-column
    dequantization scales; V: (K, d) f32 (already dequantized, it is
    thin); c/b/gamma/msq: (K,). Same return contract as
    ``quadform_heads``.
    """
    if config is None:
        config = tuning.lookup(
            "quadform_q8",
            tuning.shape_key(
                d=Z.shape[1], k=M_q.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return quadform_heads_q8_cuda(
        Z, M_q, col_scale, V, c, b, gamma, msq, config=config
    )


def rff_score(Z, W, phase, weights, bias, *, config: TileConfig | None = None):
    """Random-Fourier-feature scores.

    Z: (n, d); W: (F, d); phase: (F,); weights: (K, F) with the 2/F
    feature scaling folded in at compile time; bias: (K,). Returns
    per-head scores (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "rff_score",
            tuning.shape_key(d=Z.shape[1], f=W.shape[0], n=tuning.bucket(Z.shape[0])),
        )
    return rff_score_cuda(Z, W, phase, weights, bias, config=config)


def rff_score_q8(
    Z,
    W_q,
    w_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Random-Fourier-feature scores off int8 projection and readout.

    Z: (n, d); W_q: (F, d) int8 with per-row scales w_scale (F,);
    weights_q: (K, F) int8 with per-head scales wt_scale (K,); phase (F,)
    and bias (K,) f32. Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "rff_score_q8",
            tuning.shape_key(
                d=Z.shape[1], f=W_q.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return rff_score_q8_cuda(
        Z, W_q, w_scale, phase, weights_q, wt_scale, bias, config=config
    )


def fastfood_score(
    Z, B, G, perm, scale, phase, weights, bias, *, config: TileConfig | None = None
):
    """Fastfood (structured RFF) scores.

    Z: (n, d); B/G/scale: (stacks, d') diagonal operators; perm:
    (stacks, d'); phase: (F,) with F = stacks d'; weights: (K, F) with the
    2/F scaling folded in at compile time; bias: (K,). Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "fwht",
            tuning.shape_key(
                d=Z.shape[1], f=B.shape[0] * B.shape[1], n=tuning.bucket(Z.shape[0])
            ),
        )
    return fastfood_score_cuda(
        Z, B, G, perm, scale, phase, weights, bias, config=config
    )


def fastfood_score_q8(
    Z,
    b_q,
    g_q,
    perm,
    s_q,
    stack_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Fastfood scores off int8 operators.

    b_q/g_q/s_q: (stacks, d') int8 (b_q holds exact +-1 signs);
    stack_scale: (stacks,) f32 combined G*S row scales; perm: (stacks, d')
    int16; phase: (F,) f16; weights_q: (K, F) int8 with per-head scales
    wt_scale (K,); bias (K,) f32. Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "fwht_q8",
            tuning.shape_key(
                d=Z.shape[1],
                f=b_q.shape[0] * b_q.shape[1],
                n=tuning.bucket(Z.shape[0]),
            ),
        )
    return fastfood_score_q8_cuda(
        Z,
        b_q,
        g_q,
        perm,
        s_q,
        stack_scale,
        phase,
        weights_q,
        wt_scale,
        bias,
        config=config,
    )


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
