"""The paper's collapse (§3) and its serving primitives, in PyTorch."""

from repro_torch.core import backend
from repro_torch.core.bounds import (
    POLY2_REL_ERR_AT_HALF,
    REL_ERR_AT_HALF,
    bound_holds,
    gamma_max,
    maclaurin_exp,
    maclaurin_rel_error,
    validity_fraction,
)
from repro_torch.core.families import Budget, CompiledArtifact, compile_model
from repro_torch.core.maclaurin import (
    ApproxModel,
    approx_decision_function,
    approx_decision_function_checked,
    approx_predict_labels,
    approximate,
    hybrid_decision_function,
)
from repro_torch.core.rbf import (
    SVMModel,
    decision_function,
    model_bytes,
    predict_labels,
    rbf_kernel,
)

__all__ = [
    "ApproxModel",
    "Budget",
    "CompiledArtifact",
    "POLY2_REL_ERR_AT_HALF",
    "REL_ERR_AT_HALF",
    "SVMModel",
    "approx_decision_function",
    "approx_decision_function_checked",
    "approx_predict_labels",
    "approximate",
    "backend",
    "bound_holds",
    "compile_model",
    "decision_function",
    "gamma_max",
    "hybrid_decision_function",
    "maclaurin_exp",
    "maclaurin_rel_error",
    "model_bytes",
    "predict_labels",
    "rbf_kernel",
    "validity_fraction",
]
