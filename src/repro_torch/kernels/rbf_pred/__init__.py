from repro_torch.kernels.rbf_pred.kernel import (
    KERNEL,
    rbf_scores_cuda,
    rbf_scores_torch,
)
from repro_torch.kernels.rbf_pred.ref import rbf_predict_ref

__all__ = ["KERNEL", "rbf_predict_ref", "rbf_scores_cuda", "rbf_scores_torch"]
