"""Carry ``repro``'s parameters across as numpy arrays.

The two packages share no objects: a model built by ``repro`` (or any
other source) enters the port as plain arrays, so both packages compute
the same function on the same numbers. Loading a ``repro``-written
``.npz`` through ``CompiledArtifact.load`` is the same path for
artifacts. Every function defaults to the CUDA device and raises when no
card is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.families.base import CompiledArtifact
from repro_torch.core.maclaurin import ApproxModel
from repro_torch.core.rbf import SVMModel


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def svm_from_numpy(X, alpha_y, b, gamma, device=None) -> SVMModel:
    """An exact ``SVMModel`` from arrays: X (n_sv, d), alpha_y (n_sv,) or
    (K, n_sv), b scalar or (K,), gamma scalar."""
    dev = _device.resolve(device)
    return SVMModel(
        X=_f32(X, dev),
        alpha_y=_f32(alpha_y, dev),
        b=_f32(b, dev),
        gamma=_f32(gamma, dev),
    )


def approx_from_numpy(c, v, M, b, gamma, max_sv_sq_norm, device=None) -> ApproxModel:
    """An ``ApproxModel`` from arrays (one head, or K heads stacked)."""
    dev = _device.resolve(device)
    return ApproxModel(
        c=_f32(c, dev),
        v=_f32(v, dev),
        M=_f32(M, dev),
        b=_f32(b, dev),
        gamma=_f32(gamma, dev),
        max_sv_sq_norm=_f32(max_sv_sq_norm, dev),
    )


def artifact_from_numpy(family: str, arrays: dict, meta: dict, device=None):
    """A ``CompiledArtifact`` from arrays, keeping each array's dtype."""
    dev = _device.resolve(device)
    tensors = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()}
    return CompiledArtifact(family=family, arrays=tensors, meta=dict(meta))
