"""The ``poly2`` family — the §3.2 degree-2 polynomial expansion as an
approximation of the same RBF model.

Folds the SV-side exponential into the support values and expands
e^{2 gamma x^T z} as (1 + gamma x^T z)^2 instead of the Maclaurin series.
The artifact is the same quadratic form, served by the same kernels (B1
at f32, B3 at int8) with the same tuning buckets as maclaurin; its
per-term relative error under the Eq 3.11 envelope is 7.26% against
maclaurin's 3.05%. ``compile_model`` measures which one a model and a
budget want.
"""

from __future__ import annotations

from repro_torch.core.bounds import POLY2_REL_ERR_AT_HALF
from repro_torch.core.families import maclaurin as _mac
from repro_torch.core.families import quantize
from repro_torch.core.families.base import CompiledArtifact, stack_heads
from repro_torch.core.poly2 import collapse_rbf_as_poly2
from repro_torch.core.rbf import SVMModel

NAME = "poly2"
TILE_KERNEL = _mac.TILE_KERNEL  # same fused serving kernel
TILE_KERNEL_Q8 = _mac.TILE_KERNEL_Q8


def compile(  # noqa: A001
    svm: SVMModel,
    *,
    dtype: str = "float32",
    seed: int = 0,
    holdout=None,
    holdout_n: int = 256,
    **_opts,
) -> CompiledArtifact:
    """Collapse every head via the poly-2 expansion (Eqs 3.13-3.16).

    Same artifact kind as maclaurin, so ``dtype="int8"`` goes through the
    shared quadform quantizer.
    """
    quantize.check_dtype(dtype)
    ay2, b, _, multiclass = stack_heads(svm)
    stacked = collapse_rbf_as_poly2(
        SVMModel(X=svm.X, alpha_y=ay2, b=b, gamma=svm.gamma)
    )
    art = _mac._quadform_artifact(
        NAME, stacked, multiclass, rel_err_at_half=POLY2_REL_ERR_AT_HALF
    )
    if dtype == quantize.INT8_DTYPE:
        art = _mac.quantize_quadform_artifact(
            art, svm, seed=seed, holdout=holdout, holdout_n=holdout_n
        )
    return art


# Same artifact kind, so the same scorer and tuning resolution as maclaurin.
score = _mac.score
pad_heads = _mac.pad_heads
place_shards = _mac.place_shards
score_sharded = _mac.score_sharded
tile_lookup = _mac.tile_lookup
