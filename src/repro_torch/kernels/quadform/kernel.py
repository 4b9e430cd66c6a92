"""Kernel B1: fused K-head Eq 3.8 scores, ||z||^2 and the Eq 3.11 mask.

``quadform_heads_cuda`` launches ``csrc/quadform.cu`` (CUDA C++ for
``sm_90a``; the source's header note says what bounds it and how it is
tiled) on CUDA tensors, and computes with its plain twin
``quadform_heads_torch`` on CPU tensors. It replaces
``repro/kernels/quadform/kernel.py::quadform_heads_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import CudaKernel
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


def _check(Z, M_all, V, c, b, gamma, msq):
    n, d = Z.shape
    k = M_all.shape[0]
    shapes = {
        "M_all": (M_all, (k, d, d)),
        "V": (V, (k, d)),
        "c": (c, (k,)),
        "b": (b, (k,)),
        "gamma": (gamma, (k,)),
        "msq": (msq, (k,)),
    }
    for name, (t, shape) in {"Z": (Z, (n, d)), **shapes}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quadform_heads_cuda(
    Z, M_all, V, c, b, gamma, msq, *, config: TileConfig | None = None
):
    """Fused K-head scores. Z: (n, d), M_all: (K, d, d), V: (K, d);
    c/b/gamma/msq: (K,), all f32. Returns (scores (n, K), z_sq (n,),
    valid (n, K) bool).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if Z.device.type == "cpu":
        return quadform_heads_torch(Z, M_all, V, c, b, gamma, msq)
    if Z.device.type != "cuda":
        raise ValueError(f"quadform_heads runs on cpu or cuda, not {Z.device}")
    _check(Z, M_all, V, c, b, gamma, msq)
    n, d = Z.shape
    k = M_all.shape[0]
    config = (config or tuning.lookup("quadform")).clamp_block_n(n)
    if config.block_n not in BLOCK_N:
        raise ValueError(f"block_n must be one of {BLOCK_N}, got {config.block_n}")
    scores = torch.empty((n, k), dtype=torch.float32, device=Z.device)
    z_sq = torch.empty((n,), dtype=torch.float32, device=Z.device)
    valid = torch.empty((n, k), dtype=torch.bool, device=Z.device)
    if n == 0:
        return scores, z_sq, valid
    j_tiles = tiles.grid_blocks(d, BLOCK_J)
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
        KERNEL.launch(
            Z.data_ptr(),
            M_all.data_ptr(),
            V.data_ptr(),
            c.data_ptr(),
            b.data_ptr(),
            gamma.data_ptr(),
            msq.data_ptr(),
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
