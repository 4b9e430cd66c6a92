"""Per-(kernel, shape bucket) ``TileConfig`` resolution.

Every bucket resolves to the per-kernel Hopper default. ``repro`` also
reads a checked-in table of measured entries; the port gets one once
there are H100 measurements to put in it. Keys are canonical
``shape_key`` strings, batch dimensions bucketed by ``bucket`` — the
same policy the serving engine's buckets use.
"""

from __future__ import annotations

from repro_torch.kernels.common.config import TileConfig

DEFAULTS: dict[str, TileConfig] = {
    # B1 and B2: 128 rows a block (eight warps), the most that a block's
    # shared memory holds in a three-stage ring; small batches clamp down.
    # B3 likewise: 128 rows ran fastest at n=1024 in
    # scripts/quadform_q8_sweep.py (64 and 32 rows 1.3x and 1.9x slower).
    "quadform": TileConfig(block_n=128),
    "quadform_q8": TileConfig(block_n=128),
    "rbf_pred": TileConfig(block_n=128),
    # B4 and B5: 128 rows a block, so the W tiles are read 8 times at n=1024
    # (a block's warps split each stage's k-steps in two).
    "rff_score": TileConfig(block_n=128),
    "rff_score_q8": TileConfig(block_n=128),
    # B6/B7: the most rows a block may own (whole 16-row cos tiles); the
    # wrapper (fwht.kernel.block_rows) takes fewer where that spreads the
    # rows over more SMs. 32 gives the fastest tile of
    # scripts/fastfood_sweep.py at n=32 and 1024, F=1024 and 4096 (16, 16,
    # 16, 32 rows; NVIDIA H100 80GB HBM3, 700.00 W).
    "fwht": TileConfig(block_n=32),
    "fwht_q8": TileConfig(block_n=32),
    # B8: one 64-row sub-tile a chunk, so the exact intra-chunk term (which
    # grows with the chunk) is as small as the kernel's tiling allows. The
    # model's chunked form runs at this chunk too.
    "maclaurin_attn": TileConfig(chunk=64),
    # B9: the one tile the kernel is compiled for, whatever blocks a call
    # names (those set the reference's refusal of padded keys only).
    "flash_attn": TileConfig(block_q=64, block_k=64),
}


def shape_key(**dims) -> str:
    """Canonical bucket key: ``shape_key(d=64, k=10, n=1024) -> 'd64_k10_n1024'``."""
    return "_".join(f"{name}{int(dims[name])}" for name in sorted(dims))


def bucket(n: int, lo: int = 32, hi: int = 8192) -> int:
    """Canonical batch bucket: next power of two, floored at lo, capped at hi."""
    if n <= lo:
        return lo
    return min(hi, 1 << (int(n) - 1).bit_length())


def lookup(kernel: str, key: str | None = None) -> TileConfig:
    """The ``TileConfig`` for one (kernel, bucket).

    ``key`` names the bucket; until a measured H100 table exists every
    bucket gets the kernel's default.
    """
    if kernel not in DEFAULTS:
        raise KeyError(f"unknown kernel family {kernel!r}; known: {sorted(DEFAULTS)}")
    return DEFAULTS[kernel]

