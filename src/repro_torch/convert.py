"""Carry ``repro``'s parameters and models across as numpy arrays.

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
from repro_torch.configs.base import ModelConfig
from repro_torch.core.families.base import CompiledArtifact
from repro_torch.core.maclaurin import ApproxModel
from repro_torch.core.rbf import SVMModel
from repro_torch.models.transformer import LMParams
from repro_torch.train.tree import tree_map


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


def _numpy(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def lm_params_from_numpy(cfg: ModelConfig, params: dict, device=None) -> LMParams:
    """The port's ``LMParams`` from ``repro``'s ``init_params`` tree as numpy
    arrays, for any family: ``embed``/``lm_head``/``final_ln`` and hybrid's
    ``shared_attn`` as they are; ``layers`` (vlm: its self-attention layers)
    and vlm's ``cross_layers`` with every leaf stacked along a first axis,
    one entry a layer (``LMParams.assign``). Every parameter keeps the
    reference's key and (in, out) layout and is stored f32, as the
    reference stores it."""
    dev = _device.resolve(device)
    with torch.no_grad():
        model = LMParams(cfg, torch.Generator(device=dev), dev)
    return model.assign(tree_map(lambda x: _f32(x, dev), params))


def lm_params_to_numpy(cfg: ModelConfig, params: LMParams) -> dict:
    """``repro``'s ``init_params`` tree of ``params`` as numpy arrays, the
    inverse of ``lm_params_from_numpy``: ``layers`` and ``cross_layers``
    with every leaf stacked along a first layer axis (``LMParams.tree``)."""
    del cfg  # the tree follows the modules; kept for the inverse's signature
    return _numpy(params.tree(lambda p: p.detach()))


def opt_state_from_numpy(state: dict, device=None) -> dict:
    """The port's optimizer state from ``repro``'s (AdamW's ``m``/``v``/
    ``count``, Adafactor's ``v`` with ``vr``/``vc``/``v`` and ``count``,
    ``ef`` where present) as numpy arrays: the same keys, shapes and
    dtypes, each leaf a tensor on ``device``."""
    dev = _device.resolve(device)
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(dev), state)


def opt_state_to_numpy(state: dict) -> dict:
    """The inverse of ``opt_state_from_numpy``: every leaf a numpy copy."""
    return _numpy(state)
