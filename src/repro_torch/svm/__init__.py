"""Training: LS-SVM, the dual C-SVC and one-vs-rest ensembles.

A copy of ``repro.svm``. The trainers take tensors and run on their
device; given numpy arrays they run on ``device`` (CUDA unless the caller
passes ``device="cpu"``).
"""

from repro_torch.svm.dual import train_svc
from repro_torch.svm.lssvm import train_lssvm
from repro_torch.svm.multiclass import compile_ovr, ovr_predict, train_one_vs_rest

__all__ = [
    "compile_ovr",
    "ovr_predict",
    "train_lssvm",
    "train_one_vs_rest",
    "train_svc",
]
