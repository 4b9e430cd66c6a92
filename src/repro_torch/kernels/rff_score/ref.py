"""Plain-torch oracle for the fused random-Fourier-feature scoring kernel.

The fourier family serves

    f_k(z) = w_k . cos(W z + p) + b_k

where W (F, d) are the sampled frequencies, p (F,) the phases and w_k
the per-head weights with the 2 / F feature scaling already folded in at
compile time (``repro_torch.core.families.fourier``). The oracle is the
obviously correct three-op form the kernels and their twins are tested
against.
"""

from __future__ import annotations

import torch


def rff_score_ref(Z, W, phase, weights, bias):
    """Z: (n, d), W: (F, d), phase: (F,), weights: (K, F), bias: (K,).

    Returns per-head scores (n, K).
    """
    proj = Z @ W.T + phase[None, :]  # (n, F)
    phi = torch.cos(proj)  # feature scale folded into weights
    return phi @ weights.T + bias[None, :]  # (n, K)
