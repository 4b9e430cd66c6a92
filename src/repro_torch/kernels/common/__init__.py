"""Shared tiling and tuning for ``repro_torch.kernels.*``.

  * ``tiles``  — round-up and split arithmetic for grids over ragged
    shapes (the kernels mask their own edges, so nothing is padded);
  * ``config`` — the frozen ``TileConfig`` every kernel wrapper takes;
  * ``tuning`` — per-(kernel, shape bucket) ``TileConfig`` resolution
    with per-kernel Hopper defaults.
"""

from repro_torch.kernels.common import tiles, tuning
from repro_torch.kernels.common.config import TileConfig

__all__ = ["TileConfig", "tiles", "tuning"]
