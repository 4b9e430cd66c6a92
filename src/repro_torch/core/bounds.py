"""Approximation-validity bounds (§3.1 and Appendix A of the paper).

  * ``maclaurin_rel_error`` — Eq A.2 / Fig 1: the absolute relative error
    of the 2nd-order Maclaurin series of exp.
  * ``gamma_max``           — pre-training bound: the largest gamma for
    which Eq 3.11 is guaranteed on a given data set.
  * ``bound_holds`` / ``validity_fraction`` — run-time checks of Eq 3.11.

The guarantee chain:  |x| < 1/2  =>  rel.err(exp approx) < 3.05%   (A.2)
                      |2 gamma x_i^T z| < 1/2  for all i           (3.9)
      Cauchy-Schwarz: ||x_M||^2 ||z||^2 < 1/(16 gamma^2)           (3.11)
"""

from __future__ import annotations

import torch

# Eq A.2: sup_{|x|<1/2} |(e^x - 1 - x - x^2/2) / e^x| < 0.0305
REL_ERR_AT_HALF = 0.0305


def maclaurin_exp(x: torch.Tensor) -> torch.Tensor:
    """Second-order Maclaurin series of exp: 1 + x + x^2/2 (Eq A.1)."""
    return 1.0 + x + 0.5 * x * x


def maclaurin_rel_error(x: torch.Tensor) -> torch.Tensor:
    """Absolute relative error |(e^x - (1+x+x^2/2)) / e^x|  (Fig 1)."""
    return torch.abs((torch.exp(x) - maclaurin_exp(x)) / torch.exp(x))


def gamma_max(X: torch.Tensor) -> torch.Tensor:
    """Largest gamma guaranteeing Eq 3.11 for every pair drawn from X.

    Uses the max instance norm for both the SV and the test-point role:
    ||x_M||^2 ||z||^2 < 1/(16 gamma^2) with ||z|| <= ||x_M||
    =>  gamma < 1 / (4 ||x_M||^2).
    """
    return 1.0 / (4.0 * (X * X).sum(-1).max())


def bound_holds(max_sv_sq_norm, z_sq_norm, gamma):
    """Eq 3.11 per test instance (broadcastable)."""
    return max_sv_sq_norm * z_sq_norm < 1.0 / (16.0 * gamma**2)


def validity_fraction(max_sv_sq_norm, Z: torch.Tensor, gamma) -> torch.Tensor:
    """Fraction of a test batch adhering to Eq 3.11."""
    z_sq = (Z * Z).sum(-1)
    return bound_holds(max_sv_sq_norm, z_sq, gamma).float().mean()
