"""Roofline cost priors of the serving kernels on an NVIDIA H100.

A copy of the serving half of ``repro.launch.roofline`` (the prior
``compile_model`` prunes candidates with), with the card's constants in
place of the TPU's: 67 TFLOP/s fp32 outside the tensor cores (every
serving kernel here is fp32 SIMT) and 3.35 TB/s of HBM, the H100 SXM
data-sheet peaks at 700 W. The prior ranks candidates; measurement still
decides. The HLO-analysis half of the reference has no counterpart.
"""

from __future__ import annotations

from repro_torch.core.families.fourier import DEFAULT_NUM_FEATURES

PEAK_FLOPS = 67e12
HBM_BW = 3.35e12


def predict_seconds(flops: float, bytes_accessed: float) -> float:
    """Roofline lower bound for one kernel invocation: the binding term."""
    return max(flops / PEAK_FLOPS, bytes_accessed / HBM_BW)


def _row_blocks(n: int, block_n) -> int:
    """How many row tiles a batch of ``n`` splits into under ``block_n``."""
    n = max(1, int(n))
    b = int(block_n) if block_n else n
    b = max(1, min(b, n))
    return -(-n // b)


def quadform_tile_seconds(
    cfg, *, n: int, d: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of one fused quadform step (Eq 3.8, all K heads).

    The (K, d, d) stacked Hessian is streamed once per row tile;
    ``weight_bytes=1`` models the int8 variant.
    """
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * k * d * (d + 1)
    stream = float(blocks) * k * d * d * weight_bytes
    io = 4.0 * (n * d + n * k) + float(weight_bytes) * k * d
    return predict_seconds(flops, stream + io)


def rbf_tile_seconds(cfg, *, n: int, d: int, m: int) -> float:
    """Analytic cost of the exact expansion over ``m`` SVs (kernel B2):
    the SVs are streamed once per row tile."""
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * m * d
    stream = float(blocks) * m * d * 4.0
    io = 4.0 * (n * d + n)
    return predict_seconds(flops, stream + io)


def rff_tile_seconds(
    cfg, *, n: int, d: int, f: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of the fused RFF step (projection + readout)."""
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * f * (d + k)
    stream = float(blocks) * (f * d + k * f) * float(weight_bytes)
    io = 4.0 * (n * d + n * k)
    return predict_seconds(flops, stream + io)


def fwht_tile_seconds(
    cfg, *, n: int, d: int, f: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of the fused Fastfood step (FWHT stacks + readout).

    Per row, each of the F / d' stacks runs two d'-wide Walsh-Hadamard
    transforms plus the diagonals and the permutation, ~2 d' (log2 d' + 2)
    flops a stack, then the 2 F K readout. The O(F) diagonals (three at
    ``weight_bytes``, the phase at 4) and the (K, F) readout are streamed
    once per row tile.
    """
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    dd = 1 << max(1, (d - 1).bit_length())  # next pow2 >= d
    stacks = -(-int(f) // dd)
    fp = stacks * dd  # F rounded to stacks
    log_dd = max(1, dd.bit_length() - 1)
    flops = float(n) * (2.0 * stacks * dd * (log_dd + 2) + 2.0 * fp * k)
    stream = float(blocks) * (fp * (3.0 * weight_bytes + 4.0) + k * fp * weight_bytes)
    io = 4.0 * (n * d + n * k)
    return predict_seconds(flops, stream + io)


def family_candidate_seconds(
    family: str,
    dtype: str,
    *,
    n: int,
    d: int,
    k: int,
    num_features: int | None = None,
    structured: bool = False,
    cfg=None,
) -> float | None:
    """Predicted serving seconds for one ``compile_model`` candidate, or
    ``None`` where there is no model (the caller then measures)."""
    wb = 1 if dtype == "int8" else 4
    if family in ("maclaurin", "poly2"):
        return quadform_tile_seconds(cfg, n=n, d=d, k=k, weight_bytes=wb)
    if family == "fourier":
        f = int(num_features) if num_features else DEFAULT_NUM_FEATURES
        if structured:
            return fwht_tile_seconds(cfg, n=n, d=d, f=f, k=k, weight_bytes=wb)
        return rff_tile_seconds(cfg, n=n, d=d, f=f, k=k, weight_bytes=wb)
    return None
