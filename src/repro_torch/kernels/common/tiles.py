"""Grid arithmetic shared by the CUDA kernel wrappers.

The TPU kernels padded the feature axis to 128 lanes and the row axes to
block multiples. The CUDA kernels mask the ragged edge themselves, so the
only rule that carries over is the one padding served: a zero row,
column or coefficient changes no value.
"""

from __future__ import annotations

# Rows per block come in multiples of this (half of the 64-row tile), so
# a bucket of 32 rows does not run a 64-row tile half empty.
ROW_QUANTUM = 32


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n."""
    return -(-n // multiple) * multiple


def grid_blocks(n: int, block: int) -> int:
    """Number of blocks covering ``n`` rows at ``block`` rows per block."""
    return -(-n // block)


def split_count(tiles: int, blocks: int, target_blocks: int) -> int:
    """How many blocks share a reduction axis of ``tiles`` tiles.

    ``blocks`` blocks already run side by side; the reduction axis is cut
    into contiguous runs of whole tiles until about ``target_blocks``
    blocks are in flight. The count is chosen so that no run is empty
    (every split owns at least one tile).
    """
    if tiles <= 0:
        return 1
    want = max(1, min(tiles, -(-target_blocks // max(1, blocks))))
    per_split = -(-tiles // want)
    return -(-tiles // per_split)
