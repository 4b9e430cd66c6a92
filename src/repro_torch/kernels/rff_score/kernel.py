"""Kernels B4 and B5: fused random-Fourier-feature scores, off f32 (B4)
or int8 (B5) projection and readout weights.

``rff_score_cuda`` and ``rff_score_q8_cuda`` launch the two
instantiations of ``csrc/rff_score.cu`` (CUDA C++ for ``sm_90a``, the
projection on TF32 tensor cores; the source's header note says what
bounds it and how it is tiled) on CUDA
tensors, and compute with their plain twins ``rff_score_torch`` /
``rff_score_q8_torch`` on CPU tensors. They replace
``repro/kernels/rff_score/kernel.py::rff_score_pallas`` and
``rff_score_q8_pallas``.
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

BLOCK_F = 64  # features per tile, fixed in the source
BLOCK_N = (32, 64, 128)  # rows per block the source is compiled for
HEADS_PER_BLOCK = 48  # heads read out of one cos tile; more take further blocks

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "rff_score",
    "rff_score.cu",
    "rff_score_f32",
    [_P] * 5 + [_I] * 6 + [_P] * 2 + [_P],
)
KERNEL_Q8 = CudaKernel(
    "rff_score_q8",
    "rff_score.cu",
    "rff_score_q8",
    [_P] * 7 + [_I] * 6 + [_P] * 2 + [_P],
)


def rff_score_torch(Z, W, phase, weights, bias):
    """Plain twin of B4: two products with the cos between them (mirrors
    ``repro.core.backend.rff_score_xla``); the (n, F) features are
    materialized."""
    phi = torch.cos(Z @ W.T + phase[None, :])
    return phi @ weights.T + bias[None, :]


def rff_score_q8_torch(Z, W_q, w_scale, phase, weights_q, wt_scale, bias):
    """Plain twin of B5 (mirrors ``repro.core.backend.rff_score_q8_xla``):
    the int8 operands upcast to Z's dtype, each scale one multiply on the
    product it belongs to."""
    proj = (Z @ W_q.to(Z.dtype).T) * w_scale[None, :]
    phi = torch.cos(proj + phase[None, :])
    return (phi @ weights_q.to(Z.dtype).T) * wt_scale[None, :] + bias[None, :]


def _operands(Z, W, phase, weights, bias, w_dtype) -> dict:
    d = Z.shape[1]
    f, k = W.shape[0], weights.shape[0]
    f32 = torch.float32
    return {
        "W": (W, (f, d), w_dtype),
        "phase": (phase, (f,), f32),
        "weights": (weights, (k, f), w_dtype),
        "bias": (bias, (k,), f32),
    }


def rff_score_cuda(Z, W, phase, weights, bias, *, config: TileConfig | None = None):
    """Fused RFF scores. Z: (n, d), W: (F, d), phase: (F,), weights:
    (K, F), bias: (K,), all f32. Returns (n, K).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(Z, "rff_score"):
        return rff_score_torch(Z, W, phase, weights, bias)
    refuse_grad("rff_score", Z, W, phase, weights, bias)
    check_operands(Z, _operands(Z, W, phase, weights, bias, torch.float32))
    config = config or tuning.lookup("rff_score")
    return _launch(KERNEL, config, Z, (W, phase, weights, bias), W.shape[0], bias)


def rff_score_q8_cuda(
    Z,
    W_q,
    w_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Fused RFF scores off int8 weights. Z: (n, d) f32, W_q: (F, d) int8
    with row scales w_scale (F,), weights_q: (K, F) int8 with head scales
    wt_scale (K,), phase (F,) and bias (K,) f32. Returns (n, K).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise.
    """
    if not on_card(Z, "rff_score_q8"):
        return rff_score_q8_torch(Z, W_q, w_scale, phase, weights_q, wt_scale, bias)
    refuse_grad("rff_score_q8", Z, W_q, w_scale, phase, weights_q, wt_scale, bias)
    operands = _operands(Z, W_q, phase, weights_q, bias, torch.int8)
    operands["w_scale"] = (w_scale, (W_q.shape[0],), torch.float32)
    operands["wt_scale"] = (wt_scale, (weights_q.shape[0],), torch.float32)
    check_operands(Z, operands)
    config = config or tuning.lookup("rff_score_q8")
    args = (W_q, w_scale, phase, weights_q, wt_scale, bias)
    return _launch(KERNEL_Q8, config, Z, args, W_q.shape[0], bias)


def _launch(kernel: CudaKernel, config: TileConfig, Z, weights, f: int, bias):
    """Allocate the output and scratch and launch ``kernel`` on ``weights``
    (its pointer arguments after Z, in the C entry point's order)."""
    n, d = Z.shape
    k = bias.shape[0]
    config = config.clamp_block_n(n)
    if config.block_n not in BLOCK_N:
        raise ValueError(f"block_n must be one of {BLOCK_N}, got {config.block_n}")
    out = torch.empty((n, k), dtype=torch.float32, device=Z.device)
    if n == 0:
        return out
    f_tiles = tiles.grid_blocks(f, BLOCK_F)
    blocks = tiles.grid_blocks(n, config.block_n) * tiles.grid_blocks(
        k, HEADS_PER_BLOCK
    )
    # One block fills an SM (its ring takes most of the shared memory).
    splits = config.splits or tiles.split_count(
        f_tiles, blocks, sm_count(Z.device.index or 0)
    )
    splits = min(splits, f_tiles)
    # Scratch for the second pass. Freeing it on return is safe: the caching
    # allocator hands it out again only in the order of this stream.
    part = torch.empty((splits, n, k), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        kernel.launch(
            Z.data_ptr(),
            *(t.data_ptr() for t in weights),
            n,
            f,
            d,
            k,
            config.block_n,
            splits,
            part.data_ptr(),
            out.data_ptr(),
            stream,
        )
    return out
