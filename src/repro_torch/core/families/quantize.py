"""Symmetric int8 quantization of compiled artifacts.

A copy of ``repro.core.families.quantize`` without jax. The quantizers
run on the host in numpy float64 with round-half-to-even, exactly as the
reference does, so the same f32 parent gives the same int8 codes and the
same f32 scales, byte for byte, in either package. They take a tensor
(on any device) or an array and return numpy arrays; the caller puts
them on its device.

Scheme (weight-only, activations stay f32):

  * **Per-feature-group scales.** Weights are quantized symmetrically
    (zero-point 0) in groups of ``GROUP_SIZE`` = 16 along one axis, one
    f32 scale per group.
  * **Scales fold after the product.** Every quantized axis is an output
    axis of its contraction (Hessian columns, RFF feature rows, readout
    heads), so dequantization is one multiply on the product's result,
    never an f32 copy of the weights.
  * **Deterministic.** The same model and seed quantize to the same
    codes and scales in any process. The digest also covers the measured
    quantization error in the meta, which goes through the serving
    kernels, so whole-artifact digests reproduce only on one device and
    build.

Every quantized artifact ships its measured quantization error
(``quant_mean_abs_err`` / ``quant_max_abs_err`` against its own f32
parent on a held-out sample) in the meta, so ``compile_model`` can treat
int8 variants as candidates like any other.

``quantize_signs`` and ``compact_perm`` serve the Fastfood artifacts
only: they narrow operands that need no scale.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_DTYPE = "int8"
F32_DTYPE = "float32"
DTYPES = (F32_DTYPE, INT8_DTYPE)

# Channels per f32 sub-scale along the quantized axis.
GROUP_SIZE = 16

_QMAX = 127.0


def check_dtype(dtype: str) -> str:
    if dtype not in DTYPES:
        raise ValueError(f"artifact dtype must be one of {DTYPES}, got {dtype!r}")
    return dtype


def num_groups(n: int, group_size: int = GROUP_SIZE) -> int:
    return -(-int(n) // group_size)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def quantize_groups(x, axis: int = -1, group_size: int = GROUP_SIZE):
    """Symmetric int8 with one scale per ``group_size`` slab along ``axis``.

    Returns ``(q int8, scales f32)`` with the quantized axis of ``scales``
    reduced to ``num_groups``. All-zero groups get scale 1 (they
    dequantize to exact zeros).
    """
    x = _f64(x)
    axis = axis % x.ndim
    g = num_groups(x.shape[axis], group_size)
    pad = g * group_size - x.shape[axis]
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = np.pad(x, widths)
    shape = list(x.shape)
    shape[axis : axis + 1] = [g, group_size]
    xg = x.reshape(shape)
    absmax = np.abs(xg).max(axis=axis + 1)
    scale = np.where(absmax > 0.0, absmax / _QMAX, 1.0)
    q = np.clip(np.rint(xg / np.expand_dims(scale, axis + 1)), -_QMAX, _QMAX)
    shape[axis : axis + 2] = [g * group_size]
    q = q.reshape(shape)
    if pad:
        q = np.take(q, np.arange(x.shape[axis] - pad), axis=axis)
    return q.astype(np.int8), scale.astype(np.float32)


def quantize_col_groups(x, group_size: int = GROUP_SIZE):
    """Symmetric int8 for a (..., r, n) operand with one scale per
    (leading dims, n-group): absmax pooled over the whole row axis and the
    group slab. The stacked-Hessian layout: n is the column axis, an
    output axis of ``Z @ M``, so the (..., G) scales fold onto the product.
    """
    x = _f64(x)
    *lead, r, n = x.shape
    g = num_groups(n, group_size)
    pad = g * group_size - n
    xp = np.pad(x, [(0, 0)] * len(lead) + [(0, 0), (0, pad)])
    xg = xp.reshape(*lead, r, g, group_size)
    absmax = np.abs(xg).max(axis=(-3, -1))  # (*lead, G)
    scale = np.where(absmax > 0.0, absmax / _QMAX, 1.0)
    per_col = np.repeat(scale, group_size, axis=-1)  # (*lead, g*gs)
    q = np.clip(np.rint(xp / per_col[..., None, :]), -_QMAX, _QMAX)
    q = q[..., :n]
    return q.astype(np.int8), scale.astype(np.float32)


def expand_group_scales(scales, n: int, group_size: int = GROUP_SIZE):
    """Per-group scales back to per-element along the last axis:
    (..., G) -> (..., n). Tensors stay tensors on their device."""
    if isinstance(scales, torch.Tensor):
        return scales.repeat_interleave(group_size, dim=-1)[..., :n].contiguous()
    return np.repeat(scales, group_size, axis=-1)[..., :n]


def dequantize_groups(q, scales, group_size: int = GROUP_SIZE):
    """f32 reconstruction (tests and yardsticks, not serving paths)."""
    q = torch.as_tensor(q)
    scales = torch.as_tensor(scales, device=q.device)
    return q.to(torch.float32) * expand_group_scales(scales, q.shape[-1], group_size)


def quantize_rows(x):
    """Symmetric int8 with one scale per leading-axis row:
    (..., n) -> (q (..., n) int8, scales (...,) f32). For operands whose
    output axis is the leading one (RFF projection rows, readout heads)."""
    x = _f64(x)
    absmax = np.abs(x).max(axis=-1)
    scale = np.where(absmax > 0.0, absmax / _QMAX, 1.0)
    q = np.clip(np.rint(x / scale[..., None]), -_QMAX, _QMAX)
    return q.astype(np.int8), scale.astype(np.float32)


def quantize_signs(x) -> np.ndarray:
    """Lossless int8 encoding of an exactly-{-1, +1} operand (Fastfood's B
    diagonal). No scale: anything that is not a sign means the caller
    passed the wrong array, and raises."""
    x = _f64(x)
    if not np.all(np.abs(x) == 1.0):
        raise ValueError("sign operand must be exactly +-1 everywhere")
    return x.astype(np.int8)


def compact_perm(perm) -> np.ndarray:
    """Narrowest exact integer dtype for permutation indices: int16 when
    every index fits (d' <= 32768), int32 otherwise. Lossless either way."""
    if isinstance(perm, torch.Tensor):
        perm = perm.detach().cpu().numpy()
    perm = np.asarray(perm)
    if perm.size and perm.max() < np.iinfo(np.int16).max:
        return perm.astype(np.int16)
    return perm.astype(np.int32)


def measure_quant_error(f32_art, q_art, Z) -> dict:
    """Scores of the quantized artifact against its f32 parent on ``Z``:
    the pure quantization error, which rides in the quantized meta."""
    from repro_torch.core import families

    ref, _ = families.score_artifact(f32_art, Z)
    got, _ = families.score_artifact(q_art, Z)
    err = (got - ref).abs()
    return {
        "quant_holdout_n": int(Z.shape[0]),
        "quant_mean_abs_err": float(err.mean()),
        "quant_max_abs_err": float(err.max()),
    }
