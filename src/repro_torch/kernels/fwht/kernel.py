"""Kernels B6 and B7: fused Fastfood (structured random-Fourier-feature)
scores, off f32 (B6) or int8 (B7) operators.

``fastfood_score_cuda`` and ``fastfood_score_q8_cuda`` launch the two
instantiations of ``csrc/fastfood.cu`` (CUDA C++ for ``sm_90a``; the
source's header note says what bounds it and how a block's tile of rows
runs its transforms and reads out on the tensor cores) on CUDA tensors,
and compute with their plain twins ``fastfood_score_torch`` /
``fastfood_score_q8_torch`` on CPU tensors. They replace
``repro/kernels/fwht/kernel.py::fastfood_score_pallas`` and
``fastfood_score_q8_pallas``.

The int8 kernel reads the int8 artifact's arrays as they are stored:
int16 ``perm`` and f16 ``phase`` reach the kernel without a copy.

A block owns ``block_rows`` rows of one stack (whole 16-row cos tiles) and
up to 16 heads. With one stack a block writes the scores itself; with more
a second pass adds the stacks' partial sums. Both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel,
    check_operands,
    on_card,
    refuse_grad,
)
from repro_torch.kernels.common import TileConfig, tuning
from repro_torch.kernels.fwht.ref import fastfood_score_q8_ref, fastfood_score_ref

MAX_DD = 2048  # widest d' the source is compiled for (registers a lane)
TILE_ROWS = 16  # rows of the kernels' cos tile (one m16 fragment)
TILE_HEADS = 16  # heads a block reads out (two n8 fragments)
SMS = 132  # an H100's SMs; the kernels run one block an SM at d' = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "fastfood_score",
    "fastfood.cu",
    "fastfood_score_f32",
    [_P] * 8 + [_I] * 6 + [_P] * 2 + [_P],
)
KERNEL_Q8 = CudaKernel(
    "fastfood_score_q8",
    "fastfood.cu",
    "fastfood_score_q8",
    [_P] * 10 + [_I] * 6 + [_P] * 2 + [_P],
)

# The plain twins are the oracles: the Kronecker-product transforms, with
# the (n, F) features materialized (``repro``'s ``fastfood_score_xla`` and
# ``fastfood_score_q8_xla`` are its ``ref`` functions in the same way).
fastfood_score_torch = fastfood_score_ref
fastfood_score_q8_torch = fastfood_score_q8_ref


def _operands(Z, B, perm, phase, weights, bias, diag, perm_dtype, phase_dtype):
    """The shape and dtype every operand must have, from B's (stacks, d')."""
    stacks, dd = B.shape
    if dd & (dd - 1) or not 2 <= dd <= MAX_DD:
        raise ValueError(
            f"d' = {dd}: kernels B6/B7 take a power of two from 2 to {MAX_DD}"
        )
    if Z.shape[1] > dd:
        raise ValueError(f"Z has {Z.shape[1]} columns, more than d' = {dd}")
    f, k = stacks * dd, weights.shape[0]
    return {
        "B": (B, (stacks, dd), diag),
        "perm": (perm, (stacks, dd), perm_dtype),
        "phase": (phase, (f,), phase_dtype),
        "weights": (weights, (k, f), diag),
        "bias": (bias, (k,), torch.float32),
    }


def fastfood_score_cuda(
    Z, B, G, perm, scale, phase, weights, bias, *, config: TileConfig | None = None
):
    """Fused Fastfood scores. Z: (n, d) with d <= d'; B, G, scale:
    (stacks, d') f32; perm: (stacks, d') int32; phase: (F,) f32 with
    F = stacks d'; weights: (K, F) f32; bias: (K,) f32. Returns (n, K).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(Z, "fastfood_score"):
        return fastfood_score_torch(Z, B, G, perm, scale, phase, weights, bias)
    refuse_grad("fastfood_score", Z, B, G, perm, scale, phase, weights, bias)
    f32 = torch.float32
    operands = _operands(Z, B, perm, phase, weights, bias, f32, torch.int32, f32)
    operands["G"] = (G, B.shape, f32)
    operands["scale"] = (scale, B.shape, f32)
    check_operands(Z, operands)
    config = config or tuning.lookup("fwht")
    args = (B, G, perm, scale, phase, weights)
    return _launch(KERNEL, config, Z, args, B.shape, (), bias)


def fastfood_score_q8_cuda(
    Z,
    b_q,
    g_q,
    perm,
    s_q,
    stack_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Fused Fastfood scores off the int8 artifact's arrays. Z: (n, d) f32;
    b_q (exact +-1), g_q, s_q: (stacks, d') int8; perm: (stacks, d') int16;
    stack_scale: (stacks,) f32 combined G*S scales; phase: (F,) f16;
    weights_q: (K, F) int8 with head scales wt_scale (K,) f32; bias (K,)
    f32. Returns (n, K).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise.
    """
    if not on_card(Z, "fastfood_score_q8"):
        return fastfood_score_q8_torch(
            Z, b_q, g_q, perm, s_q, stack_scale, phase, weights_q, wt_scale, bias
        )
    operands = (Z, b_q, g_q, perm, s_q, stack_scale, phase, weights_q, wt_scale, bias)
    refuse_grad("fastfood_score_q8", *operands)
    i8, f32 = torch.int8, torch.float32
    operands = _operands(
        Z, b_q, perm, phase, weights_q, bias, i8, torch.int16, torch.float16
    )
    operands["g_q"] = (g_q, b_q.shape, i8)
    operands["s_q"] = (s_q, b_q.shape, i8)
    operands["stack_scale"] = (stack_scale, b_q.shape[:1], f32)
    operands["wt_scale"] = (wt_scale, bias.shape, f32)
    check_operands(Z, operands)
    config = config or tuning.lookup("fwht_q8")
    args = (b_q, g_q, perm, s_q, stack_scale, phase, weights_q)
    return _launch(KERNEL_Q8, config, Z, args, b_q.shape, (wt_scale,), bias)


def block_rows(block_n: int, n: int, stacks: int, k: int) -> int:
    """Rows a block of B6/B7 owns for ``n`` rows, ``stacks`` stacks and
    ``k`` heads: the multiple of 16 up to ``block_n`` (rounded up to one)
    that gives an SM the fewest rows to walk, at one block an SM (waves of
    SMS blocks times rows a block); of equals the largest, which converts
    the operators and copies the readout slice the fewest times. At n=1024,
    K=10: 16 rows with one stack of 1024 (64 blocks, one a 16-row tile),
    32 with four (128 blocks)."""
    groups = -(-k // TILE_HEADS)
    best, best_cost = TILE_ROWS, None
    for bn in range(TILE_ROWS, max(TILE_ROWS, block_n) + TILE_ROWS - 1, TILE_ROWS):
        blocks = -(-n // bn) * stacks * groups
        cost = -(-blocks // SMS) * bn
        if best_cost is None or cost <= best_cost:
            best, best_cost = bn, cost
    return best


def _launch(kernel: CudaKernel, config: TileConfig, Z, operators, shape, scales, bias):
    """Launch ``kernel`` with the tile ``config`` asks for at this shape:
    Z, then ``operators`` and ``scales`` (its pointer arguments in the C
    entry point's order), the bias."""
    n = Z.shape[0]
    stacks = shape[0]
    bn = block_rows(config.block_n, n, stacks, bias.shape[0])
    return launch_tile(kernel, Z, operators, shape, scales, bias, bn, stacks == 1)


def launch_tile(kernel: CudaKernel, Z, operators, shape, scales, bias, block_n, one):
    """Allocate the output (and, for two launches, the scratch) and launch
    ``kernel`` with ``block_n`` rows a block (a multiple of 16), in one
    launch (``one``; one stack only) or two: the sizes, then the scratch
    (null for one launch) and the output."""
    n, d = Z.shape
    stacks, dd = shape
    k = bias.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=Z.device)
    if n == 0:
        return out
    # One partial sum per (stack, row, head) for the second pass. Freeing
    # it on return is safe: the caching allocator hands it out again only
    # in the order of this stream.
    part = None
    if not one:
        part = torch.empty((stacks, n, k), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        kernel.launch(
            Z.data_ptr(),
            *(t.data_ptr() for t in operators + scales),
            bias.data_ptr(),
            n,
            d,
            dd,
            stacks,
            k,
            block_n,
            None if part is None else part.data_ptr(),
            out.data_ptr(),
            stream,
        )
    return out
