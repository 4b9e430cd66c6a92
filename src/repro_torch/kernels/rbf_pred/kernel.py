"""Kernel B2: the exact RBF expansion over K heads, streamed over SV tiles.

``rbf_scores_cuda`` launches ``csrc/rbf_pred.cu`` (CUDA C++ for
``sm_90a``; the source's header note says what bounds it and how it is
tiled) on CUDA tensors, and computes with its plain twin
``rbf_scores_torch`` on CPU tensors. It replaces
``repro/kernels/rbf_pred/kernel.py::rbf_predict_pallas`` together with the
engine's vmap of that kernel over heads: ``alpha_y`` may be (m,) or
(K, m), and every distance is shared by the K sums.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import CudaKernel, check_operands, on_card
from repro_torch.kernels.common import TileConfig, tiles, tuning

BLOCK_M = 64  # SVs per tile, fixed in the source
BLOCK_N = (32, 64, 128)  # rows per block the source is compiled for
HEADS_PER_BLOCK = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "rbf_scores",
    "rbf_pred.cu",
    "rbf_scores_f32",
    [_P] * 5 + [_I] * 6 + [_P] * 3 + [_P],
)


def _as_heads(alpha_y, b):
    """(K, m) coefficients and (K,) biases, and whether the input was 1-D."""
    single = alpha_y.ndim == 1
    A = alpha_y[None, :] if single else alpha_y
    bias = torch.as_tensor(b, dtype=A.dtype, device=A.device).reshape(-1)
    return A, bias.expand(A.shape[0]), single


def rbf_scores_torch(Z, X, alpha_y, gamma, b):
    """Plain twin: the GEMM distance trick, one (n, m) kernel matrix
    (mirrors ``repro.core.backend.rbf_scores_xla``). ``alpha_y`` (m,)
    gives (n,); (K, m) gives (n, K)."""
    A, bias, single = _as_heads(alpha_y, b)
    sq_z = (Z * Z).sum(-1)[:, None]
    sq_x = (X * X).sum(-1)[None, :]
    d2 = torch.clamp(sq_z + sq_x - 2.0 * (Z @ X.T), min=0.0)
    out = torch.exp(-gamma * d2) @ A.T + bias[None, :]
    return out[:, 0] if single else out


def rbf_scores_cuda(Z, X, alpha_y, gamma, b, *, config: TileConfig | None = None):
    """Exact f(Z) = sum_i a_i exp(-gamma ||x_i - z||^2) + b, per head.

    Z: (n, d), X: (m, d), alpha_y: (m,) or (K, m), all f32; gamma a
    scalar; b a scalar or (K,). Returns (n,) or (n, K).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(Z, "rbf_scores"):
        return rbf_scores_torch(Z, X, alpha_y, gamma, b)
    A, bias, single = _as_heads(alpha_y, b)
    bias = bias.contiguous()
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=Z.device).reshape(1)
    n, d = Z.shape
    k, m = A.shape
    f32 = torch.float32
    check_operands(
        Z,
        {
            "X": (X, (m, d), f32),
            "alpha_y": (A, (k, m), f32),
            "b": (bias, (k,), f32),
            "gamma": (gamma, (1,), f32),
        },
    )
    config = (config or tuning.lookup("rbf_pred")).clamp_block_n(n)
    if config.block_n not in BLOCK_N:
        raise ValueError(f"block_n must be one of {BLOCK_N}, got {config.block_n}")
    out = torch.empty((n, k), dtype=torch.float32, device=Z.device)
    if n == 0 or m == 0:
        out.copy_(bias.expand(n, k))
        return out[:, 0] if single else out
    m_tiles = tiles.grid_blocks(m, BLOCK_M)
    blocks = tiles.grid_blocks(n, config.block_n) * tiles.grid_blocks(
        k, HEADS_PER_BLOCK
    )
    splits = config.splits or tiles.split_count(
        m_tiles, blocks, 2 * sm_count(Z.device.index or 0)
    )
    splits = min(splits, m_tiles)
    # Scratch for the second pass. Freeing it on return is safe: the caching
    # allocator hands it out again only in the order of this stream.
    zsq = torch.empty((n,), dtype=torch.float32, device=Z.device)
    part = torch.empty((n, k, splits), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        KERNEL.launch(
            Z.data_ptr(),
            X.data_ptr(),
            A.data_ptr(),
            gamma.data_ptr(),
            bias.data_ptr(),
            n,
            m,
            d,
            k,
            config.block_n,
            splits,
            zsq.data_ptr(),
            part.data_ptr(),
            out.data_ptr(),
            stream,
        )
    return out[:, 0] if single else out
