"""Kernels B1 and B3: fused K-head Eq 3.8 scores, ||z||^2 and the Eq 3.11
mask, off an f32 (B1) or an int8 (B3) stacked Hessian.

``quadform_heads_cuda`` and ``quadform_heads_q8_cuda`` launch the two
instantiations of ``csrc/quadform.cu`` (CUDA C++ for ``sm_90a``; the
source's header note says what bounds it and how it is tiled) on CUDA
tensors, and compute with their plain twins ``quadform_heads_torch`` /
``quadform_heads_q8_torch`` on CPU tensors. They replace
``repro/kernels/quadform/kernel.py::quadform_heads_pallas`` and
``quadform_heads_q8_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import (
    CudaKernel,
    check_operands,
    on_card,
    refuse_grad,
)
from repro_torch.kernels.common import TileConfig, tiles, tuning
from repro_torch.kernels.quadform.ref import eq311_valid

BLOCK_J = 64  # Hessian columns per tile, fixed in the source
BLOCK_N = (32, 64, 128)  # rows per block the source is compiled for

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "quadform_heads",
    "quadform.cu",
    "quadform_heads_f32",
    [_P] * 7 + [_I] * 5 + [_P] * 5 + [_P],
)
KERNEL_Q8 = CudaKernel(
    "quadform_heads_q8",
    "quadform.cu",
    "quadform_heads_q8",
    [_P] * 8 + [_I] * 5 + [_P] * 5 + [_P],
)


def quadform_heads_torch(Z, M_all, V, c, b, gamma, msq):
    """Plain twin: the K Hessians as one (d, K*d) operand, so the
    quadratic term of every head comes out of one GEMM (mirrors
    ``repro.core.backend.quadform_heads_xla``)."""
    n, d = Z.shape
    k = M_all.shape[0]
    z_sq = (Z * Z).sum(-1)
    m_kd = M_all.permute(1, 0, 2).reshape(d, k * d)
    zm = (Z @ m_kd).reshape(n, k, d)
    quad = torch.einsum("nkd,nd->nk", zm, Z)
    lin = Z @ V.T
    env = torch.exp(-z_sq[:, None] * gamma[None, :])
    scores = env * (c[None, :] + lin + quad) + b[None, :]
    return scores, z_sq, eq311_valid(z_sq, gamma, msq)


def quadform_heads_q8_torch(Z, M_q, col_scale, V, c, b, gamma, msq):
    """Plain twin of B3 (mirrors ``repro.core.backend.quadform_heads_q8_xla``):
    the int8 Hessians upcast inside one GEMM for all heads, and the
    per-(head, column) scales folded onto the (n, K, d) product before
    the row-dot with Z."""
    n, d = Z.shape
    k = M_q.shape[0]
    z_sq = (Z * Z).sum(-1)
    m_kd = M_q.permute(1, 0, 2).reshape(d, k * d).to(Z.dtype)
    zm = (Z @ m_kd).reshape(n, k, d) * col_scale[None, :, :]
    quad = torch.einsum("nkd,nd->nk", zm, Z)
    lin = Z @ V.T
    env = torch.exp(-z_sq[:, None] * gamma[None, :])
    scores = env * (c[None, :] + lin + quad) + b[None, :]
    return scores, z_sq, eq311_valid(z_sq, gamma, msq)


def _heads_operands(Z, M, V, c, b, gamma, msq, m_dtype) -> dict:
    d = Z.shape[1]
    k = M.shape[0]
    f32 = torch.float32
    return {
        "M": (M, (k, d, d), m_dtype),
        "V": (V, (k, d), f32),
        "c": (c, (k,), f32),
        "b": (b, (k,), f32),
        "gamma": (gamma, (k,), f32),
        "msq": (msq, (k,), f32),
    }


def quadform_heads_cuda(
    Z, M_all, V, c, b, gamma, msq, *, config: TileConfig | None = None
):
    """Fused K-head scores. Z: (n, d), M_all: (K, d, d), V: (K, d);
    c/b/gamma/msq: (K,), all f32. Returns (scores (n, K), z_sq (n,),
    valid (n, K) bool).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(Z, "quadform_heads"):
        return quadform_heads_torch(Z, M_all, V, c, b, gamma, msq)
    refuse_grad("quadform_heads", Z, M_all, V, c, b, gamma, msq)
    check_operands(Z, _heads_operands(Z, M_all, V, c, b, gamma, msq, torch.float32))
    config = config or tuning.lookup("quadform")
    return _launch(KERNEL, config, Z, (M_all,), (V, c, b, gamma, msq))


def quadform_heads_q8_cuda(
    Z, M_q, col_scale, V, c, b, gamma, msq, *, config: TileConfig | None = None
):
    """Fused K-head scores off an int8 stacked Hessian. Z: (n, d),
    M_q: (K, d, d) int8, col_scale: (K, d) f32 per-column dequantization
    scales (expanded from the stored per-group form), V: (K, d) f32
    (dequantized); c/b/gamma/msq: (K,) f32. Same return contract as
    ``quadform_heads_cuda``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise.
    """
    if not on_card(Z, "quadform_heads_q8"):
        return quadform_heads_q8_torch(Z, M_q, col_scale, V, c, b, gamma, msq)
    refuse_grad("quadform_heads_q8", Z, M_q, col_scale, V, c, b, gamma, msq)
    operands = _heads_operands(Z, M_q, V, c, b, gamma, msq, torch.int8)
    operands["col_scale"] = (col_scale, (M_q.shape[0], Z.shape[1]), torch.float32)
    check_operands(Z, operands)
    config = config or tuning.lookup("quadform_q8")
    return _launch(KERNEL_Q8, config, Z, (M_q, col_scale), (V, c, b, gamma, msq))


def _launch(kernel: CudaKernel, config: TileConfig, Z, hessian, rest):
    """Allocate outputs and scratch and launch ``kernel``: ``hessian`` is
    (M,) for B1 and (M_q, col_scale) for B3, ``rest`` is (V, c, b, gamma,
    msq)."""
    n, d = Z.shape
    k = hessian[0].shape[0]
    config = config.clamp_block_n(n)
    if config.block_n not in BLOCK_N:
        raise ValueError(f"block_n must be one of {BLOCK_N}, got {config.block_n}")
    scores = torch.empty((n, k), dtype=torch.float32, device=Z.device)
    z_sq = torch.empty((n,), dtype=torch.float32, device=Z.device)
    valid = torch.empty((n, k), dtype=torch.bool, device=Z.device)
    if n == 0:
        return scores, z_sq, valid
    j_tiles = tiles.grid_blocks(d, BLOCK_J)
    # About two blocks an SM (one fills it, one queues). For B3 this count
    # is among the fastest of scripts/quadform_q8_sweep.py's at n = 32 and
    # 1024 (PERF.md).
    splits = config.splits or tiles.split_count(
        j_tiles,
        tiles.grid_blocks(n, config.block_n) * k,
        2 * sm_count(Z.device.index or 0),
    )
    splits = min(splits, j_tiles)
    # Scratch for the second pass. Freeing it on return is safe: the caching
    # allocator hands it out again only in the order of this stream.
    g_part = torch.empty((splits, k, n), dtype=torch.float32, device=Z.device)
    zsq_part = torch.empty((splits, n), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        kernel.launch(
            Z.data_ptr(),
            *(t.data_ptr() for t in hessian),
            *(t.data_ptr() for t in rest),
            n,
            d,
            k,
            config.block_n,
            splits,
            g_part.data_ptr(),
            zsq_part.data_ptr(),
            scores.data_ptr(),
            z_sq.data_ptr(),
            valid.data_ptr(),
            stream,
        )
    return scores, z_sq, valid
